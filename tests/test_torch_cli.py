"""The port's throughput and curve-set CLIs on the CPU
(``python -m polar_tpu_torch.throughput`` / ``.curve_set``, the
counterparts of ``scripts/throughput.py`` and ``scripts/curve_set.py``)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import polar_tpu_torch as pt
from polar_tpu_torch import ber, curve_set, throughput

ROOT = Path(__file__).resolve().parents[1]


def test_throughput_prints_a_row_per_level(capsys, monkeypatch):
    # the script's batches (131072 frames at these levels) cut for the CPU
    monkeypatch.setattr(throughput, "batch_for", lambda n: 1024)
    assert throughput.main(["--cpu", "--ms", "4", "6", "--iters", "4",
                            "--with-eager"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 2
    for row, n in zip(rows, (16, 64)):
        assert row.startswith(f"N={n:6d} [eager]")
        assert "frames/s | eager" in row and "FAILED" not in row


def test_throughput_inputs_are_the_scripts():
    """The JAX script's batch rule and its LLRs: one default_rng(5) drawn
    level after level, full-range int8."""
    for m, want in ((4, 131072), (10, 32768), (12, 8192), (16, 1024),
                    (20, 1024)):
        assert throughput.batch_for(1 << m) == want
    rng = np.random.default_rng(5)
    got = list(throughput.inputs(np.random.default_rng(5), [4, 6], "cpu"))
    for (code, llrs), m in zip(got, (4, 6)):
        assert code == pt.make_code(m, rate=0.5)
        want = rng.integers(-128, 128, (throughput.batch_for(code.N),
                                        code.N)).astype(np.int8)
        np.testing.assert_array_equal(llrs.numpy(), want)


def _count_points(monkeypatch):
    calls = []
    run_point = ber.run_point

    def counted(*args, **kwargs):
        calls.append(args[1])
        return run_point(*args, **kwargs)

    monkeypatch.setattr(ber, "run_point", counted)
    return calls


ARGS = ["--cpu", "--ms", "4", "5", "--batch", "256", "--max-frames", "512",
        "--snr-min", "-1.0", "--snr-max", "1.0"]


def test_curve_set_writes_and_resumes(tmp_path, monkeypatch):
    calls = _count_points(monkeypatch)
    plot = tmp_path / "curves.png"
    argv = ARGS + ["--outdir", str(tmp_path), "--plot", str(plot)]
    assert curve_set.main(argv) == 0
    names = [curve_set.tag(m, s) for m in (4, 5) for s in (True, False)]
    assert sorted(p.name for p in tmp_path.glob("*.json")) == sorted(
        f"{name}.json" for name in names)
    assert plot.is_file() and plot.stat().st_size > 0
    first = {name: json.loads((tmp_path / f"{name}.json").read_text())
             for name in names}
    assert len(calls) == sum(len(r["points"]) for r in first.values()) > 0
    for name, r in first.items():
        assert r["code_n"] == int(name[1:name.index("_")])
        assert r["systematic"] == ("_sys_" in name)
    # a second run resumes every campaign from its file: no new step
    calls.clear()
    assert curve_set.main(argv) == 0
    assert calls == []
    assert first == {name: json.loads((tmp_path / f"{name}.json").read_text())
                     for name in names}


def test_curve_set_without_matplotlib(tmp_path, monkeypatch):
    """The plot needs matplotlib: without it the CLI raises before the
    first campaign, and ``--plot ""`` runs the campaigns with no plot."""
    calls = _count_points(monkeypatch)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        curve_set.main(ARGS[:3] + ["--outdir", str(tmp_path)])
    assert calls == [] and list(tmp_path.iterdir()) == []
    assert curve_set.main(ARGS[:3] + ["--batch", "256", "--max-frames", "256",
                                      "--snr-min", "0.0", "--snr-max", "0.0",
                                      "--outdir", str(tmp_path),
                                      "--plot", ""]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "n16_nonsys_int8_torch.json", "n16_sys_int8_torch.json"]
    assert len(calls) == 2


def test_curve_set_never_writes_a_file_the_repo_has():
    """The default outdir is new, and the tags and the default plot name
    differ from every result file of the JAX package, wherever they go."""
    assert curve_set.DEFAULT_OUTDIR == Path("results") / "torch"
    assert not (ROOT / curve_set.DEFAULT_OUTDIR).exists() or not any(
        (ROOT / curve_set.DEFAULT_OUTDIR).iterdir())
    ours = {f"{curve_set.tag(m, s)}.json" for m in range(1, 21)
            for s in (True, False)} | {"ber_log_torch.png"}
    theirs = {p.name for p in (ROOT / "results").iterdir()}
    assert ours.isdisjoint(theirs)
    assert "ber_log_tpu.png" in theirs and "n1024_sys_int8.json" in theirs
