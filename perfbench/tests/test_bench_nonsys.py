"""The non-systematic plain reference (``reference/nonsys.py``) and its kind
of traffic (``kinds/nonsys_point.py``) on the CPU: the reference counts
what the program's draws step counts, bit for bit; through the harness the
program on the draws path comes out correct, and planted faults and the
4-bit control of ``control.py`` do not; a step on another path fails the
run. The ``cuda`` case holds ``make_step``'s own step on a card at m = 14
to the reference."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, REPO

import control
import harness
from reference import construction, nonsys

TINY = {"name": "tiny_nonsys", "level": 8, "K": 128, "systematic": False,
        "design_snr_offset_db": 1.59175, "reduced": []}
MIXES = {
    "tiny_nonsys_point": {"kind": "nonsys_point", "batch": 64,
                          "snr_db": -1.0, "steps_per_call": 1,
                          "check_steps": 3},
    "tiny_nonsys_chain": {"kind": "nonsys_point", "batch": 48,
                          "snr_db": -1.0, "steps_per_call": 2,
                          "check_steps": 2},
}
CELLS = {"t.nonsys": "tiny_nonsys_point", "t.nonsys.chain": "tiny_nonsys_chain"}
NEW_MODULES = ["kinds/nonsys_point.py", "metrics/kernels_roofline.nonsys.py",
               "metrics/draws_pct.nonsys.py",
               "metrics/entry_copy_pct.nonsys.py",
               "metrics/count_pct.nonsys.py"]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _draws_step(code, device="cpu"):
    """The program's draws step around its eager u decoder: on the CPU the
    symbols, encoder and AWGN kernels run their plain versions."""
    import polar_tpu_torch as pt
    from polar_tpu_torch import ber

    return ber.make_step_body(
        code, systematic=False, rng="kernel", device=device,
        decoder=pt.make_fastssc_decoder(code, output="u",
                                        output_dtype=torch.int8))


@pytest.mark.parametrize("level,batch", [(8, 40), (10, 24)])
@pytest.mark.parametrize("snr", [-1.5, 0.0])
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_reference_counts_what_the_draws_step_counts(level, batch, snr,
                                                     seed):
    import polar_tpu_torch as pt

    code = pt.make_code(level, 1 << (level - 1))
    ref = nonsys.code_of({"level": level, "K": code.K,
                          "design_snr_offset_db": 1.59175}, "cpu")
    np.testing.assert_array_equal(ref.frozen, code.frozen)
    step = _draws_step(code)
    program, replay = _gen(seed), _gen(seed)
    for _ in range(2):
        got = [int(v) for v in step(program, snr, batch).values()]
        want = ref.step_counters(nonsys.step_keys(replay), snr, batch, 7)
        assert got == want
    assert want[3] > 0 and want[4] > 0
    if snr < 0:
        assert want[0] > 0 and want[1] > 0


@pytest.mark.parametrize("level", [6, 9])
def test_reference_encode_equals_the_programs_plain_encoder(level):
    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import encode_kernel

    code = pt.make_code(level, rate=0.5)
    ref = nonsys.Code(construction.frozen_mask(level, code.K), "cpu")
    msg = (1 - 2 * torch.randint(0, 2, (code.K, 33), generator=_gen(level))
           ).to(torch.int8)
    want = encode_kernel.encode_plain(code, msg.t().contiguous(), False,
                                      1 << min(level, 4))
    np.testing.assert_array_equal(ref.reencode(msg).t().numpy(), want.numpy())


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark's pieces copied, with a tiny non-systematic code and
    mixes added as new files and new entries only."""
    root = tmp_path_factory.mktemp("perfbench_nonsys")
    for folder in ("configs", "traffic", "kinds", "metrics"):
        shutil.copytree(BENCH / folder, root / folder)
    (root / "configs" / "tiny_nonsys.json").write_text(json.dumps(TINY))
    (root / "configs" / "tiny_sys.json").write_text(
        json.dumps({**TINY, "name": "tiny_sys", "systematic": True}))
    for name, mix in MIXES.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {**{c: ("tiny_nonsys", m) for c, m in CELLS.items()},
             "t.nonsys.sys": ("tiny_sys", "tiny_nonsys_point")}
    for cell, (config, mix) in cells.items():
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": mix, "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] == "sim_frames_per_s" or m["name"].endswith(
                    ".nonsys"):
                m["workloads"].append(cell)
    return harness.Bench(spec, root)


def _program(decode):
    """The program's own decode entry. Under a wrap the kind runs the
    program's draws step, which ``make_step`` does not take on the CPU."""
    return decode


def _run(bench, cell, seed=2**31 + 7, wrap=None, seconds=0.3):
    return harness.run(bench, cell, seed, seconds, False,
                       t_start=time.perf_counter(), device="cpu", wrap=wrap)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_draws_step_runs_correct(bench, cell):
    out = _run(bench, cell, wrap=_program)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["counter_gap"] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"sim_frames_per_s", "setup_s"}
    assert out["attempted"] >= 1


def _altered(monkeypatch):
    """A decode whose first bit of each call is turned."""
    def wrap(decode):
        def run(llr):
            out = decode(llr).clone()
            out[0, 0] = -1 if out[0, 0] >= 0 else 1
            return out
        return run
    return wrap


def _shifted_keys(monkeypatch):
    """Draws that pass over one key of the point's stream before each of
    theirs, so the noise key of the draws path's order becomes the first
    step's message key."""
    from polar_tpu_torch import ber

    seeds = ber._philox_seeds

    def shifted(gen):
        seeds(gen)
        return seeds(gen)

    monkeypatch.setattr(ber, "_philox_seeds", shifted)
    return _program


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [_altered, _shifted_keys])
def test_planted_faults_come_out_incorrect(bench, cell, fault, monkeypatch):
    out = _run(bench, cell, wrap=fault(monkeypatch))
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_the_control_comes_out_incorrect(bench, cell, seed):
    """``control.py``'s control for the kind: the reference's decode at 4
    bits in the place of the step's decode entry."""
    w = bench.workload(cell)
    mix = bench.traffic(w["traffic"])
    wrap = control.control_wrap(mix["kind"], bench.config(w["config"]), mix,
                                torch.device("cpu"))
    out = _run(bench, cell, seed=seed, wrap=wrap)
    assert not out["correct"]
    assert all(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_step_on_another_path_fails_the_run(bench):
    """``make_step``'s own step at m = 8 on the CPU is the fused step, whose
    streams the reference does not replay."""
    with pytest.raises(harness.BenchError, match="draws path"):
        _run(bench, "t.nonsys")


def test_a_systematic_code_fails_the_run(bench):
    with pytest.raises(harness.BenchError, match="systematic"):
        _run(bench, "t.nonsys.sys")


def test_the_readers_read_the_spans_and_the_trace():
    b = harness.Bench({})
    run = {"trace": {"busy_s": 2.0}, "attempted": 4, "n": 16384, "k": 8192,
           "frames": 4 * 4096, "program": {"device_by_span": {
               "kernel.channel_symbols": 0.01, "kernel.block_encoder": 0.02,
               "kernel.channel_awgn": 0.07, "decode.transpose_in": 0.1,
               "decode.transpose_out": 0.05, "step.count": 0.2,
               "kernel.interp_decoder": 1.5}}}
    assert b.reader("draws_pct.nonsys").read(run) == pytest.approx(5.0)
    assert b.reader("entry_copy_pct.nonsys").read(run) == pytest.approx(7.5)
    assert b.reader("count_pct.nonsys").read(run) == pytest.approx(10.0)
    roof = b.reader("kernels_roofline.nonsys")
    sys_model = b.reader("kernels_roofline.campaign")
    n, k, f = 16384, 8192, 4096
    assert sys_model.step_work(n, k, f)[1] - roof.step_work(n, k, f)[1] == \
        2 * sys_model.transform_ops(n) * f
    assert 0 < roof.read(run) < 100
    # a program without the span (or without the recorder) gives nothing
    del run["program"]["device_by_span"]["step.count"]
    assert b.reader("count_pct.nonsys").read(run) is None
    run["program"] = None
    assert all(b.reader(name).read(run) is None for name in (
        "draws_pct.nonsys", "entry_copy_pct.nonsys", "count_pct.nonsys"))


def test_the_new_modules_import_no_jax_and_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "from reference import nonsys\n"
        "for f in %r:\n"
        "    harness._load_module(harness.HERE / f)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m.startswith('polar')))\n"
    ) % (str(BENCH), str(REPO), NEW_MODULES)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_make_step_on_the_card_equals_the_reference(card):
    """``make_step(systematic=False)`` at m = 14, B = 64 takes the draws
    path on a card (symbols, encoder and AWGN kernels, the auto decoder's
    u track) and counts what the reference counts."""
    import polar_tpu_torch as pt
    from polar_tpu_torch import ber

    code = pt.make_code(14, 8192)
    step = pt.make_step(code, systematic=False, device=card)
    ref = nonsys.code_of({"level": 14, "K": 8192,
                          "design_snr_offset_db": 1.59175}, card)
    before = dict(ber.steps_by_path)
    program, replay = _gen(2**31 + 21), _gen(2**31 + 21)
    for snr in (-1.5, -1.5, 0.0):
        got = [int(v) for v in step(program, snr, 64).values()]
        assert got == ref.step_counters(nonsys.step_keys(replay), snr, 64,
                                        64)
    assert ber.steps_by_path["draws"] - before["draws"] == 3
    assert got[3] > 0
