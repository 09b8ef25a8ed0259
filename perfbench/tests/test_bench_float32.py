"""The float32 plain reference (``reference/float32.py``) and its kind of
traffic (``kinds/decode_stream_f32.py``) on the CPU: the reference decodes
what the program's float decoder decodes, bit for bit; through the harness
the program comes out correct, and the reference computed in bfloat16 in
its place, planted faults and ``control.py``'s 4-bit control do not. The
``cuda`` case holds ``make_auto_decoder``'s float kernel on a card at
Polar(1024, 512) to the reference."""

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
from reference import construction, float32

TINY = {"name": "tiny_f32", "level": 8, "K": 128, "systematic": True,
        "llr": "float32", "design_snr_offset_db": 1.59175, "reduced": []}
MIX = {"kind": "decode_stream_f32", "batch": 512, "snr_db": -1.0, "pool": 3,
       "in_flight": 2, "check_batches": 3}
CELL = "t.f32.decode"
NEW_MODULES = ["kinds/decode_stream_f32.py",
               "metrics/kernels_roofline.f32decode.py"]


def _gen(seed, device="cpu"):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("level,batch", [(6, 33), (8, 40), (10, 24)])
@pytest.mark.parametrize("snr", [-1.0, 1.0])
def test_reference_decodes_what_the_programs_float_decoder_decodes(
        level, batch, snr):
    import polar_tpu_torch as pt

    code = pt.make_code(level, 1 << (level - 1))
    ref = float32.Code(construction.frozen_mask(level, code.K), "cpu")
    np.testing.assert_array_equal(ref.frozen, code.frozen)
    dec = pt.make_fastssc_decoder(code, output="u", output_dtype=torch.int8)
    for llr in ref.channel_batches(_gen(level), snr, 2, batch):
        assert llr.dtype == torch.float32
        want = ref.decode_frames(llr, 7)
        assert torch.equal(dec(llr), want)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark's pieces copied, with a tiny float code and mix added
    as new files and new entries only."""
    root = tmp_path_factory.mktemp("perfbench_f32")
    for folder in ("configs", "traffic", "kinds", "metrics"):
        shutil.copytree(BENCH / folder, root / folder)
    (root / "configs" / "tiny_f32.json").write_text(json.dumps(TINY))
    (root / "traffic" / "tiny_f32_pool.json").write_text(json.dumps(MIX))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny_f32",
                              "traffic": "tiny_f32_pool", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "n1024.f32.decode" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return harness.Bench(spec, root)


def _run(bench, seed=2**31 + 7, wrap=None, seconds=0.3):
    return harness.run(bench, CELL, seed, seconds, False,
                       t_start=time.perf_counter(), device="cpu", wrap=wrap)


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_the_float_decode_runs_correct(bench, seed):
    out = _run(bench, seed)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["bits_off"] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"decoded_frames_per_s", "decode_p95_ms",
                                   "setup_s"}
    assert out["attempted"] >= 2


def _bfloat16(config):
    """The reference in bfloat16 in the program's place."""
    ref = float32.Code(construction.frozen_mask(
        config["level"], config["K"], config["design_snr_offset_db"]),
        "cpu", dtype=torch.bfloat16)
    return lambda program: lambda llr: ref.decode_frames(llr, 64)


def _flipped(config):
    """A decode whose first bit of each call is turned."""
    def wrap(decode):
        def run(llr):
            out = decode(llr).clone()
            out[0, 0] = -1 if out[0, 0] >= 0 else 1
            return out
        return run
    return wrap


def _half_repeated(config):
    """A decode whose second half of each batch repeats its first."""
    def wrap(decode):
        def run(llr):
            out = decode(llr).clone()
            half = out.shape[0] // 2
            out[half:2 * half] = out[:half]
            return out
        return run
    return wrap


def _four_bits(config):
    """``control.py``'s control: the int8 reference at 4 bits."""
    return control.control_wrap(MIX["kind"], config, MIX, torch.device("cpu"))


@pytest.mark.parametrize("fault", [_bfloat16, _flipped, _half_repeated,
                                   _four_bits])
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_the_controls_and_faults_come_out_incorrect(bench, fault, seed):
    out = _run(bench, seed, wrap=fault(TINY))
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["bits_off"]["value"] > 0


def test_the_roofline_reads_the_kernel_span():
    b = harness.Bench({})
    roof = b.reader("kernels_roofline.f32decode")
    frozen = construction.frozen_mask(10, 512)
    nbytes, ops = roof.decode_work(frozen, 32768)
    assert nbytes == (4 * 1024 + 512) * 32768
    # f and g over every level's rows at most: N log2 N a frame
    assert 0 < ops < 1024 * 10 * 32768
    run = {"frames": 32768, "frozen": frozen, "trace": {"busy_s": 1.0},
           "program": {"device_by_span": {
               "kernel.f32_decoder_frames": 1.5e-3}}}
    share = roof.read(run)
    assert share == pytest.approx(100 * nbytes / 3.35e12 / 1.5e-3)
    assert 0 < share < 100
    # a program without the span (or without the recorder) gives nothing
    run["program"]["device_by_span"] = {"kernel.scratch_decoder_frames": 1.0}
    assert roof.read(run) is None
    run["program"] = None
    assert roof.read(run) is None


def test_the_new_modules_import_no_jax_and_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "from reference import float32\n"
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
def test_the_auto_decoder_on_the_card_equals_the_reference(card):
    """``make_auto_decoder(output="u")`` at Polar(1024, 512) on a card
    takes the float kernel for float32 LLRs, one launch a call, and
    decodes what the reference decodes."""
    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import decoder_kernel

    code = pt.make_code(10, 512)
    ref = float32.Code(construction.frozen_mask(10, 512), card)
    dec, _ = pt.make_auto_decoder(code, output="u", device=card)
    for llr in ref.channel_batches(_gen(2**31 + 3, card), -1.0, 2, 4097):
        before = decoder_kernel.launches["f32_decoder_frames"]
        got = dec(llr)
        assert decoder_kernel.launches["f32_decoder_frames"] == before + 1
        assert torch.equal(got, ref.decode_frames(llr, 4097))
