"""The harness on the CPU at a size a test run holds: it finds pieces added
as new files, its runs come out correct on the program, and the control
and the planted faults come out not correct.

The CPU runs skip the look for a card (``device="cpu"``) and drive the
rest of a run: the program's plain CPU paths in the window, the reference
check after it."""

import json
import shutil
import time

import pytest
import torch
from conftest import BENCH, REPO

import control
import harness

TINY = {"name": "tiny", "level": 7, "K": 64, "systematic": True,
        "design_snr_offset_db": 1.59175, "reduced": []}
MIXES = {
    "tiny_point": {"kind": "campaign_point", "batch": 96, "snr_db": 0.5,
                   "steps_per_call": 1, "check_steps": 3},
    "tiny_chain": {"kind": "campaign_point", "batch": 64, "snr_db": 0.5,
                   "steps_per_call": 3, "check_steps": 2},
    "tiny_pool": {"kind": "decode_stream", "batch": 96, "snr_db": 0.5,
                  "pool": 3, "in_flight": 2, "check_batches": 3},
}
CELLS = {"t.point": "tiny_point", "t.chain": "tiny_chain",
         "t.decode": "tiny_pool"}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark's pieces copied, with a tiny code and mixes added as
    new files and new entries only."""
    root = tmp_path_factory.mktemp("perfbench")
    for folder in ("configs", "traffic", "kinds", "metrics"):
        shutil.copytree(BENCH / folder, root / folder)
    (root / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, mix in MIXES.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, mix in CELLS.items():
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": mix, "chips": 1, "why": "test"})
        kind = MIXES[mix]["kind"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and (m["name"].endswith(
                    ".campaign" if kind == "campaign_point" else ".decode")
                    or m["name"] in (("sim_frames_per_s",)
                                     if kind == "campaign_point" else
                                     ("decoded_frames_per_s",
                                      "decode_p95_ms"))):
                m["workloads"].append(cell)
    return harness.Bench(spec, root)


def _run(bench, cell, seed=2**31 + 7, wrap=None, seconds=0.3):
    return harness.run(bench, cell, seed, seconds, False,
                       t_start=time.perf_counter(), device="cpu", wrap=wrap)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_runs_correct(bench, cell):
    out = _run(bench, cell)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in bench.end_to_end(cell)}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] >= 1


def _half_step(step):
    """Half of the batch left out, the mean taken over the rest."""
    def run(gen, snr_db, batch, *more):
        out = step(gen, snr_db, batch // 2, *more)
        return {k: 2 * v for k, v in out.items()}
    return run


def _altered_step(step):
    """An answer altered where it is produced."""
    def run(gen, snr_db, batch, *more):
        out = dict(step(gen, snr_db, batch, *more))
        out["awgn_errors"] = out["awgn_errors"] + 1
        return out
    return run


def _half_decode(dec):
    def run(llr):
        half = llr.shape[0] // 2
        out = dec(llr[:half])
        return torch.cat([out, out[: llr.shape[0] - half]])
    return run


def _altered_decode(dec):
    def run(llr):
        out = dec(llr).clone()
        out[-1, -1] = -out[-1, -1] if out[-1, -1] else 1
        return out
    return run


FAULTS = [("t.point", _half_step), ("t.point", _altered_step),
          ("t.chain", _half_step), ("t.chain", _altered_step),
          ("t.decode", _half_decode), ("t.decode", _altered_decode)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_planted_faults_come_out_incorrect(bench, cell, fault):
    out = _run(bench, cell, wrap=fault)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_comes_out_incorrect(bench, cell, seed):
    w = bench.workload(cell)
    mix = bench.traffic(w["traffic"])
    wrap = control.control_wrap(mix["kind"], bench.config(w["config"]), mix,
                                torch.device("cpu"))
    out = _run(bench, cell, seed=seed, wrap=wrap)
    assert not out["correct"]
    assert all(c["value"] > c["limit"] for c in out["checks"].values())


def test_new_kind_and_metric_are_found_as_files(bench, tmp_path):
    root = tmp_path / "pb"
    shutil.copytree(bench.root, root)
    (root / "kinds" / "echo_kind.py").write_text(
        "class D:\n"
        "    def window(self, seconds, spans):\n"
        "        with spans('echo'):\n"
        "            pass\n"
        "        return {'metrics': {'echo_per_s': 5.0}, 'attempted': 1,\n"
        "                'window_ns': (0, 1), 'window_s': 1.0}\n"
        "    def release(self):\n"
        "        pass\n"
        "    def check(self):\n"
        "        return {'echo_gap': (0, 0)}, 0\n"
        "def prepare(config, mix, seed, device, wrap=None):\n"
        "    return D()\n")
    (root / "traffic" / "echo_mix.json").write_text('{"kind": "echo_kind"}')
    (root / "metrics" / "echo_spans.new.py").write_text(
        "def read(run):\n"
        "    return float(len(run['spans'].seconds('echo')))\n")
    spec = json.loads(json.dumps(bench.spec))
    spec["workloads"].append({"name": "t.echo", "config": "tiny",
                              "traffic": "echo_mix", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "echo_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["t.echo"]})
    spec["per_layer"].append({"name": "echo_spans.new", "unit": "spans",
                              "better": "lower", "source": "host_clock",
                              "layer": "echo", "moves": "echo_per_s",
                              "workloads": ["t.echo"]})
    b = harness.Bench(spec, root)
    out = _run(b, "t.echo")
    assert out["correct"]
    assert set(out["metrics"]) == {"echo_per_s", "setup_s"}
    assert [m["name"] for m in b.per_layer("t.echo")] == ["echo_spans.new"]
    assert b.reader("echo_spans.new").read(
        {"spans": _spans_with("echo")}) == 1.0


def _spans_with(name):
    s = harness.Spans()
    with s(name):
        pass
    return s


def test_no_card_no_result(bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.BenchError):
        harness.run(bench, "t.point", 1, 0.1, False,
                    t_start=time.perf_counter())


def test_missing_piece_no_result(bench):
    spec = json.loads(json.dumps(bench.spec))
    spec["workloads"].append({"name": "t.gone", "config": "tiny",
                              "traffic": "no_such_mix", "chips": 1,
                              "why": "test"})
    with pytest.raises(harness.BenchError):
        _run(harness.Bench(spec, bench.root), "t.gone")
