"""Smoke run of polar_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from ``polar_tpu_torch/csrc``, holds each against
its plain PyTorch version, drives the port's main path at Polar(1024, 512)
int8 through them (the decode benchmark at batch 32768, then a BER
campaign), and times kernel against plain version. Phases print one line
each; any failure raises, so the script exits non-zero and prints no
result. The last two lines are the kernel table and the device line.

    python3 chip_smoke.py          # from the repository root, one GPU

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AVX2_REFERENCE_FPS_N1024 = 2_983_104.0  # bench.py:27, a CPU figure
BATCH = 32768
SIGMAS = 4.0  # width of the statistical bounds


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bounds_ok(f1, n1, f2, n2) -> tuple[bool, float]:
    """|p1 - p2| within SIGMAS pooled binomial standard deviations."""
    p = (f1 + f2) / (n1 + n2)
    sd = math.sqrt(max(p * (1 - p), 0.0) * (1 / n1 + 1 / n2))
    return abs(f1 / n1 - f2 / n2) <= SIGMAS * sd, sd


def ber_ok(e1, n1, e2, n2, k) -> tuple[bool, float]:
    """BER within SIGMAS standard deviations, with the per-frame bound
    var(BER estimate) <= BER / frames (a frame's error fraction lies in
    [0, 1], so its variance is at most its mean)."""
    b = (e1 + e2) / ((n1 + n2) * k)
    sd = math.sqrt(b * (1 / n1 + 1 / n2))
    return abs(e1 / (n1 * k) - e2 / (n2 * k)) <= SIGMAS * sd, sd


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.decode.auto import make_kernel_decoder
    from polar_tpu_torch.ops.cuda import build, decoder_kernel, step_kernel
    from polar_tpu_torch.utils.benchmark import (elapsed_seconds,
                                                 measure_decode_fps)

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    # -- 1. environment and build ------------------------------------------
    print(card, flush=True)
    phase("1", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    phase("1", f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            phase("1", "ptxas " + line.strip())

    code = pt.make_code(10, rate=0.5)
    program = pt.compile_program(code)
    n, k = code.N, code.K
    err = {"fastssc_decoder_u": 0, "fastssc_decoder_cw": 0, "mc_step": 0}

    # -- 2. decoder kernel: golden vectors, then the plain version ---------
    with np.load(ROOT / "tests" / "vectors" / "golden.npz") as z:
        vec = dict(z.items())
    batches = 0
    for key in sorted(vec):
        if not key.startswith("mask_"):
            continue
        _, m, rk = key.split("_")
        gcode = pt.PolarCode(int(m), vec[key])
        dec = make_kernel_decoder(gcode, output="u")
        i = 0
        while f"llr_{m}_{rk}_{i}" in vec:
            got = dec(torch.from_numpy(vec[f"llr_{m}_{rk}_{i}"]).to(dev)).cpu()
            if not np.array_equal(got.numpy(), vec[f"dec_{m}_{rk}_{i}"]):
                raise AssertionError(f"golden decode mismatch m={m} rate={rk} batch={i}")
            batches += 1
            i += 1
    phase("2", f"decoder kernel equals {batches} golden dec_* batches (m=2..14)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    llr_t = torch.randint(-128, 128, (n, BATCH), generator=gen, device=dev,
                          dtype=torch.int8)
    assert bool((llr_t == -128).any()), "full-range LLRs must include -128"
    for mode in ("u", "systematic", "codeword", "both"):
        got = make_kernel_decoder(code, output=mode).lane_major(llr_t)
        want = pt.make_fastssc_decoder(code, output=mode,
                                       output_dtype=torch.int8).lane_major(llr_t)
        got, want = (got, want) if mode == "both" else ((got,), (want,))
        diff = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
        err["fastssc_decoder_cw" if mode != "u" else "fastssc_decoder_u"] = max(
            err["fastssc_decoder_cw" if mode != "u" else "fastssc_decoder_u"], diff)
        if diff:
            raise AssertionError(f"kernel decoder differs from plain, output={mode}")
    phase("2", f"Polar({n}, {k}) B={BATCH} full-range int8: kernel == plain "
          "in u, systematic, codeword and both (max abs err 0)")

    # -- 3. step kernel, inject mode, against the plain chain --------------
    def inject_pair(c, batch, snr, systematic, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        msg = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                     device=dev)).to(torch.int8)
        nrm = torch.randn((c.N, batch), generator=g, device=dev)
        args = (pt.compile_program(c), c.frozen, snr_params(snr), systematic)
        a = step_kernel.step(*args, msg_t=msg, normals_t=nrm).cpu()
        b = step_kernel.step_plain(*args, msg_t=msg, normals_t=nrm).cpu()
        return a, b

    for systematic in (True, False):
        for snr in (-1.0, 2.0):
            a, b = inject_pair(code, BATCH, snr, systematic, 7)
            if not torch.equal(a, b):
                raise AssertionError(f"inject step differs: sys={systematic} "
                                     f"snr={snr}: {a.tolist()} vs {b.tolist()}")
            phase("3", f"inject sys={systematic} snr={snr}: counters "
                  f"{a.tolist()} equal the plain chain")
    levels = range(pt.ber.STEP_KERNEL_MIN_LEVEL, pt.ber.STEP_KERNEL_MAX_LEVEL + 1)
    for level in levels:
        lc = pt.make_code(level, rate=0.5)
        for systematic in (True, False):
            a, b = inject_pair(lc, 512, 1.0, systematic, level)
            if not torch.equal(a, b):
                raise AssertionError(f"inject step differs at m={level} "
                                     f"sys={systematic}")
    phase("3", f"inject step == plain chain at every level {levels.start}.."
          f"{levels.stop - 1}, both modes, B=512")

    # -- 4. step kernel, native mode ---------------------------------------
    args = (program, code.frozen)
    quiet = step_kernel.step(*args, snr_params(20.0), True, seeds=(11, 12),
                             call=1, batch=BATCH, device=dev).cpu()
    if quiet.tolist() != [0, 0, 0, 0, 0]:
        raise AssertionError(f"native step at 20 dB counted errors: {quiet.tolist()}")
    phase("4", "native step at 20 dB: counters all zero")
    # the two versions draw identical Philox words; only an ulp difference in
    # log/sqrt between the kernel and torch could move an LLR across a
    # rounding boundary. Tolerance: 3 frames' worth of bits, 1e-4 of the
    # channel counters.
    for systematic in (True, False):
        kw = dict(seeds=(2024, 7), call=3, batch=BATCH, device=dev)
        a = step_kernel.step(*args, snr_params(1.0), systematic, **kw).cpu()
        b = step_kernel.step_plain(*args, snr_params(1.0), systematic, **kw).cpu()
        d = (a - b).abs().tolist()
        tol = [3 * k, 3, 3 * k, 1e-4 * int(b[3]) + 3, 1e-4 * int(b[4]) + 3]
        if any(x > t for x, t in zip(d, tol)):
            raise AssertionError(f"native step sys={systematic}: {a.tolist()} "
                                 f"vs plain {b.tolist()}")
        err["mc_step"] = max(err["mc_step"], max(d))
        phase("4", f"native sys={systematic} 1 dB: kernel {a.tolist()} plain "
              f"{b.tolist()} (|diff| {d})")

    # -- 5. the main path: decode benchmark and BER campaign ---------------
    for counts in (decoder_kernel.launches, step_kernel.launches,
                   decoder_kernel.plain_calls, step_kernel.plain_calls):
        for name in counts:
            counts[name] = 0
    dec, desc = pt.make_auto_decoder(code, output="u", device=dev)
    rng = np.random.default_rng(42)
    llrs = torch.from_numpy(
        rng.integers(-128, 128, (BATCH, n)).astype(np.int8)).to(dev)
    fps = measure_decode_fps(dec, llrs, iters=64)
    phase("5", f"decode benchmark ({desc}): {fps:.1f} frames/s at "
          f"Polar({n}, {k}) B={BATCH}, vs_baseline "
          f"{fps / AVX2_REFERENCE_FPS_N1024:.3f} ({card})")
    t0 = time.perf_counter()
    res = pt.run_campaign(code, device=dev, seed=5, batch=BATCH,
                          snr_range=(-1.0, 1.0), snr_step=0.2,
                          max_frames_per_point=1 << 17)
    wall = time.perf_counter() - t0
    launched = {**decoder_kernel.launches, **step_kernel.launches}
    plain = {**decoder_kernel.plain_calls, **step_kernel.plain_calls}
    if min(launched.values()) == 0 or max(plain.values()) != 0:
        raise AssertionError(f"main path launches {launched}, plain calls {plain}")
    phase("5", f"campaign {len(res.points)} points in {wall:.1f} s; launches "
          f"{launched}; plain calls {plain}; decode gauge "
          f"{res.peak_mbps:.1f} info Mbit/s")
    ref = json.loads((ROOT / "results" / "n1024_sys_int8.json").read_text())
    ref_pts = {round(p["snr_db"], 1): p for p in ref["points"]}
    compared = 0
    for p in res.points:
        r = ref_pts.get(round(p.snr_db, 1))
        if not (np.isfinite(p.ber) and 0 <= p.ber <= 1):
            raise AssertionError(f"BER out of range at {p.snr_db}: {p.ber}")
        if r is None:
            continue
        ok_f, sd_f = bounds_ok(p.fer * p.frames, p.frames,
                               r["fer"] * r["frames"], r["frames"])
        ok_b, sd_b = ber_ok(p.bit_errors, p.frames, r["bit_errors"],
                            r["frames"], k)
        phase("5", f"snr {p.snr_db + 0.0:+.1f} dB: BER {p.ber:.4g} FER {p.fer:.4g} "
              f"({p.frames} frames) vs JAX-package result BER {r['ber']:.4g} "
              f"FER {r['fer']:.4g} ({r['frames']} frames), "
              f"{SIGMAS:g}-sigma bounds {SIGMAS * sd_b:.3g} / {SIGMAS * sd_f:.3g}")
        if not (ok_f and ok_b):
            raise AssertionError(f"campaign point {p.snr_db} outside bounds")
        compared += 1
    if compared < 5:
        raise AssertionError("too few campaign points compared")

    # -- 6. timings, kernel against plain version --------------------------
    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        return elapsed_seconds(lambda: [fn() for _ in range(reps)], dev) / reps * 1e3

    frozen = code.frozen
    times = {}
    for name, want_cw in (("fastssc_decoder_u", False), ("fastssc_decoder_cw", True)):
        times[name] = (
            ms(lambda: decoder_kernel.decode(program, frozen, llr_t, want_cw), 20),
            ms(lambda: decoder_kernel.decode_plain(program, frozen, llr_t, want_cw), 3))
    kw = dict(seeds=(99, 98), call=1, batch=BATCH, device=dev)
    times["mc_step"] = (
        ms(lambda: step_kernel.step(program, frozen, snr_params(1.0), True, **kw), 20),
        ms(lambda: step_kernel.step_plain(program, frozen, snr_params(1.0), True,
                                          **kw), 3))
    for name, (t_k, t_p) in times.items():
        phase("6", f"{name}: kernel {t_k:.3f} ms ({BATCH / t_k * 1e3:.4g} frames/s), "
              f"plain {t_p:.3f} ms ({BATCH / t_p * 1e3:.4g} frames/s) at "
              f"Polar({n}, {k}) B={BATCH} ({card})")

    replaces = {
        "fastssc_decoder_u": ("polar_tpu_torch/csrc/decoder.cu",
                              "polar_tpu/ops/pallas/decoder_kernel.py:404"),
        "fastssc_decoder_cw": ("polar_tpu_torch/csrc/decoder.cu",
                               "polar_tpu/ops/pallas/decoder_kernel.py:410"),
        "mc_step": ("polar_tpu_torch/csrc/step.cu",
                    "polar_tpu/ops/pallas/step_kernel.py:328"),
    }
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launched[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in replaces.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
