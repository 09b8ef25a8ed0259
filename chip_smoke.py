"""Smoke run of polar_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from ``polar_tpu_torch/csrc``, checks the tile
decoder's packed byte functions against the scalar ones, holds each kernel
against its plain PyTorch version, drives the port's main path at
Polar(1024, 512) int8 through them (the decode benchmark at batch 32768,
then a BER campaign), and times kernel against plain version, the tile
decoder against the walk it replaced (phases 1-6). The fused step: the
tile step against the plain chain on injected inputs at every level and
against the walk it replaced on the same seeds (3, 4), a campaign through
make_step's default path where that path is the fused step (5), the tile
step against the walk in turns at that shape and at Polar(1024, 512) (6).
Then the large-N path at Polar(131072, 65536) systematic int8: the tile
subtree decoder against its plain version and the walk in every body at
levels 1-9, and the hybrid against the whole-code kernel (7), the block
front's kernels A and B (the row-word kernels) against the plain versions,
and the counter kernel (8), the large-N step against the fused step and a
BER campaign against the JAX package's result (its default path the block
front and the interpreter's decode+count), a plain campaign (the draws
around the hybrid: the tile subtree's launches), with timings, the tile
subtree against the walk in turns and kernels A and B and the counter at
B = 4096 and the campaign's batch (9). Then the caller's-decoder path at
both shapes of its campaigns: the symbols, AWGN and block-encoder kernels
against their plain versions, and timed (10); the pinned-decoder step
with the kernel draws at both codes: exact counters on injected words,
one chained campaign a shape (its launches and steps counted alone)
against the JAX package's results,
step rates against the torch draws, and the SC decoder on the card (11).
Then the element-major front step: the whole-block front (the row-word
kernel), decode+count (the tile kernel) and the middle-stages kernel
against their plain versions, the first two also against the kernels
they replaced (styles "thread" and "walk"), the front chains against the
fused step at every level 2..16, chained campaigns through make_step's
default path at Polar(1024, 512) up to Polar(16384, 8192) and the front
path's own run (launches of the new kernels only) against the JAX
package's results, and timings, rows 6 and 8 in turns with the kernels
they replaced, kernels A and B and the counter beside their plain
versions (12). Then the decoder's scratch (shared-memory) and interpreter
styles: the scratch whole-code kernel (the packed tile kernel at the
shapes of its table) against the golden vectors, its plain version and
the SSA kernel at every level and batch class of the table; the scratch
and interpreter subtree kernels in every distinct kernel node of the
hybrid at Polar(131072, 65536); the hybrid in each style and the
interpreter decoder (u, cw, both at subtree levels 5 and 10) against the
SSA decoders and the plain version; interpreter decode+count against its
plain version and the block-interp front chain against block-hybrid;
the grid size, grid steps and tile runs of each interpreter program
launched; the slice's main path through run_point; make_step's default
path at plain Polar(32768, 16384), B = 4096, which runs the interpreter's
tile kernel, and its decoder against the plain one; timings of the
scratch kernels and the interpreter's rows 13, 14, 15 (14). Then
the parallel layer over a mesh of 8 positions on the one card: the
ring-shift kernel against its plain version; the sharded encoder; the
element-sharded decoder at Polar(131072, 65536) against the local decoder
over both transports, its ring-kernel run the slice's main path; the
frame-sharded step and a sharded point against the JAX package's result;
dryrun_multichip(8); the multihost CLI as two processes on the card and
resumed from its checkpoint; timings (15). Then the modules of the last
slice (16): the native construction and compiler built from the port's C
source against numpy; the code store and the decoder cache; the
throughput CLI's per-N table (m = 6..16, the decoders auto picks, their
launches, no plain call); the curve-set CLI at m = 8 and 10, both modes,
against the JAX package's result files and resumed with no new step; a
campaign point traced through utils.profiling; the fused step's bits mode
against native mode on the same Philox words and timed in turns with it.
Then the frame-major u track of the tile kernels (17), rows 1 and 3's
main path: the auto decoder's frame-major entry at Polar(1024, 512),
B = 4096 and 32768 (the tile kernel's and the scratch kernel's (B, N)
launch, no copy) against plain and the transposing entry around the same
kernels, bit for bit and in turns; rows 1 and 3's frame-major launches
and each tile shape's against plain and in turns with their element-major
launches by device time (rows 1 and 3 take their ms from it). Then the
draws path's u-domain counter (18): ``count_frames_kernel`` against its
plain version on the 16-byte and byte paths at Polar(16384, 8192),
B = 4096 and Polar(1024, 512), B = 32768, timed in turns with it (device
time, host hidden) beside its bound, and a non-systematic campaign on
the draws path (one launch a step). Then the interpreter's frame-major u
track (19), row 13's main path: its (B, N) launch at Polar(8192, 4096),
Polar(16384, 8192) and Polar(131072, 65536), B = 64 to 16384, against
plain and in turns with the element-major launch and the transposing
entry around it. Then the float32 u track (20): the float kernel against
the eager float decoder at Polar(1024, 512), B = 32768, through the auto
decoder's u entry too, and timed in turns with the eager decoder. Last,
each kernel's bound (13,
reckoned in polar_tpu_torch/utils/cost.py); the rows of the draws and
front kernels carry the steps that made their launches, rows 9 A, 9 B,
10-12, 1, 3 and 4s their numbers at each shape ("by_shape") too.
Phases print one line each; any failure raises,
so the script exits non-zero and prints no result. The last three lines
are the card, the kernel table and the device line.

    python3 chip_smoke.py          # from the repository root, one GPU

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AVX2_REFERENCE_FPS_N1024 = 2_983_104.0  # bench.py:27, a CPU figure
BATCH = 32768
LARGE_M = 17          # Polar(131072, 65536), results/n131072_sys_int8.json
LARGE_BATCH = 4096
# phase 5: the batch of the campaign through make_step's default path at
# Polar(1024, 512), one below ber.AUTO_BIG_BATCH, where that path is the
# fused step (from AUTO_BIG_BATCH it is the front's whole branch)
FUSED_PATH_BATCH = 4096
SIGMAS = 4.0  # width of the statistical bounds
# phase 12: (m, SNR range, step) of the chained campaigns against
# results/n<N>_sys_int8.json. The front path's own run takes make_step's
# default path at Polar(2^FRONT_PATH_M, 2^(FRONT_PATH_M - 1)), B = BATCH,
# the front's whole branch there (the row-word front, the tile
# decode+count), with a result file; the campaigns whose make_step path is
# the block front launch the middle kernel; the kernels are checked and
# timed at those shapes.
CAMPAIGNS = ((10, (-1.0, 0.0), 0.2), (12, (-1.6, -1.2), 0.2),
             (13, (-1.5, -1.2), 0.1), (14, (-1.6, -1.2), 0.2))
FRONT_PATH_M = 8
PAR_SHARDS = 8   # phase 15: mesh positions on the one card
# phase 14: batches at which the scratch tile kernel is held against plain
# and the byte kernel at every level, a batch of each class of its shape
# table (decoder_kernel.SCRATCH_BATCHES) with ragged and tiny ones; the
# plain code of make_step's default path whose auto decoder is the
# interpreter (decode/auto.py AUTO_DECODERS, below BIG_BATCH)
SCRATCH_BATCHES = (31, 4096, 4099, 16384, BATCH)
MID_PATH_M = 15
# phases 10-11: (m, batch) of the pinned-decoder campaigns, the shapes at
# which the symbols, AWGN and encoder kernels are checked, timed and counted
DRAW_SHAPES = ((10, BATCH), (LARGE_M, LARGE_BATCH))

# Every kernel's work and bound ("bound_ms") is reckoned in
# polar_tpu_torch/utils/cost.py (row_work, bound).


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def stages(counts: dict) -> str:
    """The register block's counter (``ops/cuda/tile_stages.py``): a
    tile's transform and fold stages in registers and in shared memory."""
    return (f"stages in registers {counts['reg_stages']}, in shared memory "
            f"{counts['smem_stages']}")


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


def count_inputs(gen, rows: int, batch: int, dev):
    """(llr, cw, hat) for the counter: full-range int8 LLRs, ±1
    codewords, estimates with about 1 % zeros and 1 % flipped signs."""
    import torch

    def rand_i8(lo, hi):
        return torch.randint(lo, hi, (rows, batch), generator=gen, device=dev,
                             dtype=torch.int8)

    llr = rand_i8(-128, 128)
    cw = (1 - 2 * rand_i8(0, 2)).to(torch.int8)
    hat = cw.clone()
    hat[rand_i8(0, 100) == 0] = 0
    hat[rand_i8(0, 100) == 0] *= -1
    return llr, cw, hat


def ms_dropped(fn, reps: int) -> float:
    """ms a call of ``fn`` on the card: CUDA events around ``reps`` calls,
    each result dropped as the next call starts, so every launch gets the
    block its predecessor freed from the caching allocator."""
    import torch

    from polar_tpu_torch.utils.benchmark import elapsed_seconds

    def run():
        for _ in range(reps):
            fn()

    fn()
    torch.cuda.synchronize()
    return elapsed_seconds(run, "cuda") / reps * 1e3


def in_turns(new_fn, old_fn, reps: int) -> dict:
    """The new design and the one it replaced, timed new, old, old, new by
    :func:`ms_dropped` on the same inputs."""
    t = [ms_dropped(new_fn, reps)]
    o = [ms_dropped(old_fn, reps), ms_dropped(old_fn, reps)]
    t.append(ms_dropped(new_fn, reps))
    return {"ms": sum(t) / 2, "earlier_ms": sum(o) / 2,
            "turns": f"new {t[0]:.4f}, {t[1]:.4f}; old {o[0]:.4f}, "
                     f"{o[1]:.4f}"}


def ms_kept(fn, reps: int) -> float:
    """ms a call of ``fn``, as phases 6-14 time a kernel against its plain
    version: CUDA events around ``reps`` calls whose results stay alive
    until the last ends."""
    import torch

    from polar_tpu_torch.utils.benchmark import elapsed_seconds

    fn()
    torch.cuda.synchronize()
    return elapsed_seconds(lambda: [fn() for _ in range(reps)],
                           "cuda") / reps * 1e3


def profiled_ms(fn, reps: int, tries: int = 3) -> str:
    """Device time a call of ``fn`` by torch.profiler, as text: the device
    time of the kernels ``reps`` calls launch, over ``reps``. The profiler
    at times records no device activity in a session, or misses the
    kernels and keeps a stray small one; a session that records no device
    time, or less than a tenth of the CUDA-event time of the same calls,
    is tried again, up to ``tries`` in all, and then the reading is given
    as not recorded (the CUDA-event times beside it in each phase line
    stand). It is a reading only: no check rests on it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us / 1e3 >= start.elapsed_time(end) / 10:
            return f"{us / 1e3 / reps:.4f} ms"
    return (f"not recorded (no device time, or under a tenth of the events' "
            f"time, in {tries} profiler sessions)")


def _reset(*counts) -> None:
    for c in counts:
        for name in c:
            c[name] = 0


def _subtree_nodes(tree, levels, kinds=("branch", "rate0_right",
                                         "rate1_comb")):
    """One node of each kind at each level that emits message bits: by
    default the composite kinds the hybrid sends to a subtree kernel."""
    out, stack = {}, [tree]
    while stack:
        node = stack.pop()
        if node.level in levels and node.mesg_bits >= 1 and node.kind in kinds:
            out.setdefault((node.level, node.kind), node)
        stack.extend(c for c in (node.left, node.right) if c is not None)
    return [out[k] for k in sorted(out)]


def campaign_vs_reference(label, res, name, k, need) -> None:
    """A phase line per campaign point against the JAX package's result
    file ``results/<name>``; raises unless at least ``need`` points lie
    within the bounds."""
    import numpy as np

    ref = json.loads((ROOT / "results" / name).read_text())
    ref_pts = {round(p["snr_db"], 1): p for p in ref["points"]}
    within = 0
    for p in res.points:
        r = ref_pts[round(p.snr_db, 1)]
        if not (np.isfinite(p.ber) and 0 <= p.ber <= 1):
            raise AssertionError(f"BER out of range at {p.snr_db}: {p.ber}")
        ok_f, sd_f = bounds_ok(p.fer * p.frames, p.frames,
                               r["fer"] * r["frames"], r["frames"])
        ok_b, sd_b = ber_ok(p.bit_errors, p.frames, r["bit_errors"],
                            r["frames"], k)
        within += ok_f and ok_b
        phase(label, f"Polar({res.code_n}, {k}) snr {p.snr_db + 0.0:+.1f} dB: "
              f"BER {p.ber:.4g} FER {p.fer:.4g} ({p.frames} frames) vs "
              f"{name} BER {r['ber']:.4g} FER {r['fer']:.4g} ({r['frames']} "
              f"frames), {SIGMAS:g}-sigma bounds {SIGMAS * sd_b:.3g} / "
              f"{SIGMAS * sd_f:.3g}: {'ok' if ok_f and ok_b else 'OUTSIDE'}")
    if within < need:
        raise AssertionError(f"only {within} of {len(res.points)} campaign "
                             f"points within bounds of {name}")


def large_n_phases(dev, card, ms) -> dict:
    """Phases 7-9: the large-N path at Polar(131072, 65536)."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.decode import auto
    from polar_tpu_torch.decode.auto import make_kernel_decoder
    from polar_tpu_torch.ops.cuda import (channel_kernel, count_kernel,
                                          decoder_kernel, encode_kernel,
                                          front_kernel, interp_kernel,
                                          step_kernel, subtree_kernel)
    from polar_tpu_torch.utils.cost import bound, row_work

    code = pt.make_code(LARGE_M, rate=0.5)
    n, k, b = code.N, code.K, LARGE_BATCH
    frozen = code.frozen
    kl = auto.hybrid_kernel_level(LARGE_M)
    err = {"subtree_decoder": 0, "front_blocks_a": 0, "front_blocks_b": 0,
           "count": 0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)

    def rand_i8(rows, batch, lo=-128, hi=128):
        return torch.randint(lo, hi, (rows, batch), generator=gen, device=dev,
                             dtype=torch.int8)

    def max_err(got, want):
        return max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))

    # -- 7. subtree decoder: every body, then the hybrid at full width -----
    # the tile subtree against its plain version and the walk it replaced,
    # bit for bit, at every level the hybrid launches, at the batches of
    # both campaigns and one off the 16-byte word; column 0 of each slot is
    # all -128, column 1 all zero, the left hard blocks hold zeros
    tree = pt.compile_code(code)
    nodes = _subtree_nodes(tree, range(1, kl + 1),
                           ("branch", "rate0_right", "rate1_comb", "rate1",
                            "rep", "spc"))
    bodies = 0
    for batch in (b, auto.BIG_BATCH, b + 3):
        for node in nodes:
            m_n = 1 << node.level
            slot = rand_i8(2 * m_n, batch)
            slot[:, 0], slot[:, 1] = -128, 0
            hl, cwl = rand_i8(m_n, batch, -1, 2), rand_i8(m_n, batch, -1, 2)
            for fuse in (None, "f", "g"):
                for emit_u, emit_cw in ((True, False), (True, True),
                                        (False, True)):
                    kw = dict(emit_u=emit_u, emit_cw=emit_cw, fuse=fuse)
                    args = ((slot[:m_n],) if fuse is None else (slot,)
                            if fuse == "f" else
                            (slot, hl) + ((cwl,) if emit_cw else ()))
                    before = dict(subtree_kernel.launches)
                    got = subtree_kernel.make_subtree_decoder(node, **kw)(*args)
                    walk = subtree_kernel.make_subtree_decoder(
                        node, style="walk", **kw)(*args)
                    if subtree_kernel.launches != {
                            **before,
                            "subtree_decoder": before["subtree_decoder"] + 1,
                            "walk_subtree": before["walk_subtree"] + 1}:
                        raise AssertionError(f"subtree launches "
                                             f"{subtree_kernel.launches}")
                    want = subtree_kernel.decode_plain(node, args, **kw)
                    e = max(max_err(got, want), max_err(got, walk))
                    err["subtree_decoder"] = max(err["subtree_decoder"], e)
                    if e or not len(got) == len(want) == len(walk):
                        raise AssertionError(
                            f"subtree body differs: {node.kind} level "
                            f"{node.level} B={batch} fuse={fuse} u={emit_u} "
                            f"cw={emit_cw}")
                    bodies += 1
    phase("7", f"tile subtree == plain == walk in {bodies} bodies (nodes "
          f"{[(nd.kind, nd.level) for nd in nodes]}, fuse none/f/g, u, u+cw, "
          f"cw, B = {b}, {auto.BIG_BATCH}, {b + 3}) on full-range int8 slots "
          "with a -128 and a zero column (max abs err 0)")

    llr_t = rand_i8(n, b)
    for mode in ("u", "systematic", "codeword", "both"):
        whole = make_kernel_decoder(code, output=mode).lane_major(llr_t)
        whole = whole if mode == "both" else (whole,)
        for fuse, style in ((False, "ssa"), (True, "ssa"), (True, "walk")):
            hyb = pt.make_fastssc_decoder(code, output=mode,
                                          output_dtype=torch.int8,
                                          kernel_level=kl, kernel_fuse=fuse,
                                          kernel_style=style)
            lane = hyb.lane_major(llr_t)
            lane = lane if mode == "both" else (lane,)
            e = max_err(lane, whole)
            if not fuse:
                frame = hyb(llr_t.t().contiguous())
                frame = frame if mode == "both" else (frame,)
                e = max(e, max_err([f.t() for f in frame], whole))
            if e:
                raise AssertionError(f"hybrid differs from the whole-code "
                                     f"kernel, output={mode} fuse={fuse} "
                                     f"style={style}")
        del whole, lane
    phase("7", f"hybrid kl{kl} == whole-code kernel at Polar({n}, {k}) B={b}, "
          "u/systematic/codeword/both, lane entry with and without fusion, "
          "frame entry, and in the walk style (max abs err 0)")

    # -- 8. block front and counter kernel ----------------------------------
    # kernels A and B against the plain versions
    msg = (1 - 2 * rand_i8(n, b, 0, 2)).to(torch.int8)
    nrm = torch.randn((n, b), generator=gen, device=dev)
    params = snr_params(-1.5)
    blk_a = 1 << min(front_kernel.BLOCK_LEVEL, LARGE_M)
    blk_b = 1 << min(front_kernel.CHAN_BLOCK_LEVEL, LARGE_M)
    for systematic in (True, False):
        kw = dict(msg_t=msg, normals_t=nrm)
        x = front_kernel.msg_blocks_plain(frozen, blk_a, systematic, msg_t=msg)
        want = front_kernel.chan_blocks_plain(
            front_kernel.middle_plain(x, frozen, blk_a, blk_b, systematic), blk_b,
            params, normals_t=nrm) + (() if systematic else (x,))
        got = front_kernel.front_blocks(frozen, params, systematic, **kw)
        e = max_err(got, want)
        err["front_blocks_a"] = max(err["front_blocks_a"], e)
        err["front_blocks_b"] = max(err["front_blocks_b"], e)
        if e:
            raise AssertionError(f"inject front differs, sys={systematic}")
        del got, want, x
    phase("8", f"inject front == plain at "
          f"Polar({n}, {k}) B={b}, both modes, blocks "
          f"2^{front_kernel.BLOCK_LEVEL}/2^{front_kernel.CHAN_BLOCK_LEVEL}")
    kw = dict(seeds=(2024, 8), call=1)
    for systematic in (True, False):
        xp = front_kernel.msg_blocks_plain(frozen, blk_a, systematic, batch=b,
                                           device=dev, **kw)
        xa = front_kernel.msg_blocks(frozen, blk_a, systematic, batch=b,
                                     device=dev, **kw)
        e_a = max_err([xa], [xp])
        err["front_blocks_a"] = max(err["front_blocks_a"], e_a)
        phase("8", f"native kernel A sys={systematic}: max abs err {e_a} "
              "against plain")
        if e_a:
            raise AssertionError(f"native kernel A differs, sys={systematic}")
        del xa, xp
    xa = front_kernel.msg_blocks(frozen, blk_a, True, batch=b, device=dev, **kw)
    y = front_kernel.middle_plain(xa, frozen, blk_a, blk_b, True)
    want = front_kernel.chan_blocks_plain(y, blk_b, params, **kw)
    got = front_kernel.chan_blocks(y, blk_b, params, **kw)
    e_b = max_err(got, want)
    err["front_blocks_b"] = max(err["front_blocks_b"], e_b)
    moved = int((got[0] != want[0]).sum())
    phase("8", f"native kernel B on the same Philox words: max abs err {e_b} "
          f"against plain ({moved} of {n * b} LLRs moved)")
    if e_b:
        raise AssertionError("native kernel B differs from plain")
    del xa, y, want
    llr_c, cw_c = got
    hat = cw_c.clone()
    hat[rand_i8(n, b, 0, 100) == 0] = 0
    hat[rand_i8(n, b, 0, 100) == 0] *= -1
    got_c = count_kernel.count(frozen, llr_c, cw_c, hat)
    want_c = count_kernel.count_plain(frozen, llr_c, cw_c, hat)
    e = int((got_c - want_c).abs().max())
    err["count"] = e
    if e:
        raise AssertionError(f"count kernel {got_c.tolist()} vs plain "
                             f"{want_c.tolist()}")
    phase("8", f"count kernel (rows) == plain at "
          f"Polar({n}, {k}) B={b}: {got_c.tolist()}")

    # -- 9. the large-N step and campaign -----------------------------------
    for level in (14, pt.ber.STEP_KERNEL_MAX_LEVEL, LARGE_M):
        lc = pt.make_code(level, rate=0.5)
        for systematic in (True, False):
            chain = pt.ber.make_front_chain(lc, systematic=systematic)
            kw = dict(seeds=(level, 99), call=0, batch=2048, device=dev)
            got = chain(snr_params(-1.4), **kw).cpu()
            want = step_kernel.step(pt.compile_program(lc), lc.frozen,
                                    snr_params(-1.4), systematic, **kw).cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"large-N step {got.tolist()} vs fused "
                                     f"step {want.tolist()} at m={level} "
                                     f"sys={systematic}")
            phase("9", f"m={level} sys={systematic}: large-N step == fused "
                  f"step on the same seeds, B=2048: {got.tolist()}")

    counts = (decoder_kernel.launches, step_kernel.launches,
              subtree_kernel.launches, front_kernel.launches,
              count_kernel.launches, interp_kernel.launches,
              channel_kernel.launches, encode_kernel.launches)
    plains = (decoder_kernel.plain_calls, step_kernel.plain_calls,
              subtree_kernel.plain_calls, front_kernel.plain_calls,
              count_kernel.plain_calls, interp_kernel.plain_calls,
              channel_kernel.plain_calls, encode_kernel.plain_calls)
    # steps of auto.BIG_BATCH frames. The systematic code's default path is
    # the block front and the interpreter's decode+count (ber.front_branch);
    # the plain campaign pins the hybrid (the default since decode.auto's
    # table names the interpreter here is phase 14's), whose SSA subtree
    # kernel runs around the kernel draws
    cb = auto.BIG_BATCH
    _reset(*counts, *plains)
    t0 = time.perf_counter()
    res = pt.run_campaign(code, device=dev, seed=3, batch=cb,
                          snr_range=(-1.7, -1.4), snr_step=0.1,
                          max_frames_per_point=cb, measure_throughput=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {name: v for c in counts for name, v in c.items()}
    plain = {name: v for c in plains for name, v in c.items()}
    new = ("front_blocks_a", "front_blocks_b", "count", "interp_decode_count")
    steps = sum(p.frames for p in res.points) // cb
    if (min(launched[name] for name in new) == 0 or max(plain.values()) != 0
            or launched["count"] != steps
            or launched["interp_decode_count"] != steps):
        raise AssertionError(f"large-N campaign launches {launched} in "
                             f"{steps} steps, plain calls {plain}")
    phase("9", f"campaign Polar({n}, {k}) sys "
          f"({pt.ber.front_branch(code, True)}): {len(res.points)} points x "
          f"{cb} frames ({steps} steps) in {wall:.1f} s; launches "
          f"{ {name: v for name, v in launched.items() if v} }; plain calls "
          f"{max(plain.values())}")
    campaign_vs_reference("9", res, "n131072_sys_int8.json", k, 3)
    hybrid = pt.make_fastssc_decoder(code, output_dtype=torch.int8,
                                     kernel_level=kl)
    _reset(*counts, *plains)
    t0 = time.perf_counter()
    res_p = pt.run_campaign(code, systematic=False, device=dev, seed=4,
                            decoder=hybrid, batch=cb, snr_range=(-1.4, -1.4),
                            max_frames_per_point=2 * cb,
                            measure_throughput=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched_p = {name: v for c in counts for name, v in c.items()}
    plain = {name: v for c in plains for name, v in c.items()}
    steps_p = sum(p.frames for p in res_p.points) // cb
    if (launched_p["subtree_decoder"] == 0 or launched_p["walk_subtree"]
            or max(plain.values()) != 0
            or not all(0 < p.ber < 0.5 for p in res_p.points)):
        raise AssertionError(f"large-N plain campaign launches {launched_p} "
                             f"in {steps_p} steps, plain calls {plain}, "
                             f"points {res_p.points}")
    phase("9", f"campaign Polar({n}, {k}) plain (draws around the pinned "
          f"hybrid kl{kl}): "
          f"{len(res_p.points)} point, {steps_p * cb} frames ({steps_p} "
          f"steps of {cb}) "
          f"in {wall:.1f} s, BER {res_p.points[0].ber:.4g}; launches "
          f"{ {name: v for name, v in launched_p.items() if v} }")
    launched["subtree_decoder"] = launched_p["subtree_decoder"]

    # timings at Polar(131072, 65536): the subtree kernel at the largest
    # level-kl node, at the campaign's batch (its launches) and at B = 4096,
    # the tile kernel against the walk in turns; a small node too
    times, earlier = {}, {}
    node = max(_subtree_nodes(tree, (kl,)), key=lambda nd: nd.mesg_bits)
    small = max(_subtree_nodes(tree, (4,)), key=lambda nd: nd.mesg_bits)
    for nd, batch in ((node, cb), (node, b), (small, cb)):
        sl = rand_i8(1 << nd.level, batch)
        tile = subtree_kernel.make_subtree_decoder(nd, emit_u=False,
                                                   emit_cw=True)
        walk = subtree_kernel.make_subtree_decoder(nd, emit_u=False,
                                                   emit_cw=True, style="walk")
        t = [ms(lambda: tile(sl), 10)]
        w = [ms(lambda: walk(sl), 10), ms(lambda: walk(sl), 10)]
        t.append(ms(lambda: tile(sl), 10))
        phase("9", f"subtree cw, {nd.kind} level {nd.level} node, B={batch}: "
              f"tile kernel {t[0]:.4f}, {t[1]:.4f} ms; walk {w[0]:.4f}, "
              f"{w[1]:.4f} ms ({sum(w) / sum(t):.2f}x) ({card})")
        if nd is node and batch == cb:
            slot = sl
            times["subtree_decoder"] = (
                sum(t) / 2,
                ms(lambda: subtree_kernel.decode_plain(
                    node, (slot,), emit_u=False, emit_cw=True), 2))
            earlier["subtree_decoder"] = sum(w) / 2
    # kernels A and B with each output dropped as the next launch starts,
    # at B = 4096 and at the campaign's batch; plain at B = 4096
    kw = dict(seeds=(5, 6), call=0)
    y = front_kernel.middle_plain(msg, frozen, blk_a, blk_b, True)
    by_shape = {"front_blocks_a": {}, "front_blocks_b": {}}
    for batch in (b, cb):
        yb = y if batch == b else (1 - 2 * rand_i8(n, batch, 0, 2)).to(
            torch.int8)
        where = f"Polar({n}, {k}) B={batch}"
        for name, fn in (
                ("front_blocks_a", lambda: front_kernel.msg_blocks(
                    frozen, blk_a, True, batch=batch, device=dev, **kw)),
                ("front_blocks_b", lambda: front_kernel.chan_blocks(
                    yb, blk_b, params, **kw))):
            t = {"ms": ms_dropped(fn, 10)}
            by_shape[name][where] = t
            phase("9", f"{name} at {where}: kernel {t['ms']:.4f} ms ({card})")
        del yb
    times["front_blocks_a"] = (
        by_shape["front_blocks_a"][f"Polar({n}, {k}) B={b}"]["ms"],
        ms(lambda: front_kernel.msg_blocks_plain(frozen, blk_a, True, batch=b,
                                                 device=dev, **kw), 2))
    times["front_blocks_b"] = (
        by_shape["front_blocks_b"][f"Polar({n}, {k}) B={b}"]["ms"],
        ms(lambda: front_kernel.chan_blocks_plain(y, blk_b, params, **kw), 2))
    for name in by_shape:
        by_shape[name].pop(f"Polar({n}, {k}) B={b}")
        by_shape[name][f"Polar({n}, {k}) B={cb}"].update(
            launches=launched[name], steps=steps, plain_ms=None,
            work=row_work(name, n=n, k=k, b=cb))
    # the counter at B = 4096 and at the campaign's batch; there first on
    # all-wrong LLRs (llr = -cw: N B = 2^31 AWGN errors, past int32), then
    # on the inputs timed; plain at B = 4096
    del llr_c, cw_c, hat
    count_in = {b: count_inputs(gen, n, b, dev),
                cb: count_inputs(gen, n, cb, dev)}
    flip = count_in[b][1].repeat(1, cb // b)
    for args in ((-flip, flip, flip), count_in[cb]):
        got = count_kernel.count(frozen, *args)
        want = count_kernel.count_plain(frozen, *args)
        e = int((got - want).abs().max())
        err["count"] = max(err["count"], e)
        phase("9", f"count kernel (rows) == plain at "
              f"Polar({n}, {k}) B={cb}: {got.tolist()} (max abs err {e})")
        if e:
            raise AssertionError(f"count kernel {got.tolist()} vs plain "
                                 f"{want.tolist()} at B={cb}")
    del flip, got, want
    by_shape["count"] = {}
    for batch in (b, cb):
        where = f"Polar({n}, {k}) B={batch}"
        args = count_in[batch]
        t = {"ms": ms_dropped(lambda: count_kernel.count(frozen, *args), 10)}
        by_shape["count"][where] = t
        dev_ms = profiled_ms(lambda: count_kernel.count(frozen, *args), 10)
        phase("9", f"count at {where}: kernel {t['ms']:.4f} ms, bound "
              f"{bound(*row_work('count', n=n, k=k, b=batch))[0]:.4f} ms; "
              f"device time (profiler) {dev_ms} ({card})")
    t = by_shape["count"].pop(f"Polar({n}, {k}) B={b}")
    times["count"] = (t["ms"], ms(lambda: count_kernel.count_plain(
        frozen, *count_in[b]), 2))
    by_shape["count"][f"Polar({n}, {k}) B={cb}"].update(
        launches=launched["count"], steps=steps, plain_ms=None,
        work=row_work("count", n=n, k=k, b=cb))
    del count_in, args
    out = subtree_kernel.make_subtree_decoder(node, emit_u=False,
                                              emit_cw=True)(slot)
    work = {
        "subtree_decoder": row_work("subtree_decoder", n=slot.shape[0],
                                    b=cb),
        **{name: row_work(name, n=n, k=k, b=b)
           for name in ("front_blocks_a", "front_blocks_b", "count")},
    }
    for name, (t_k, t_p) in times.items():
        where = (f"the level-{kl} node B={cb}" if name == "subtree_decoder"
                 else f"Polar({n}, {k}) B={b}")
        phase("9", f"{name}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms at "
              f"{where} ({card})")
    program = pt.compile_program(code)
    for want_cw in (False, True):
        track = "cw" if want_cw else "u"
        t_whole = ms(lambda: decoder_kernel.decode(program, frozen, llr_t,
                                                   want_cw), 2)
        line = [f"whole-code {t_whole:.1f}"]
        for level in sorted({kl - 2, kl, min(kl + 2, LARGE_M - 1)}):
            hyb = pt.make_fastssc_decoder(
                code, output="codeword" if want_cw else "u",
                output_dtype=torch.int8, kernel_level=level).lane_major
            line.append(f"hybrid kl{level} {ms(lambda: hyb(llr_t), 2):.1f}")
        phase("9", f"decoder {track} track ms at Polar({n}, {k}) B={b}: "
              f"{', '.join(line)} ({card})")
    chain = pt.ber.make_front_chain(code, systematic=True)
    t_step = ms(lambda: chain(snr_params(-1.4), seeds=(1, 2), call=0,
                              batch=b, device=dev), 2)
    phase("9", f"large-N step (systematic, {pt.ber.front_branch(code, True)}"
          f"): {t_step:.1f} ms per {b} frames, {b / t_step * 1e3:.1f} "
          f"frames/s ({card})")
    rows = ("subtree_decoder", "front_blocks_a", "front_blocks_b", "count")
    return {"err": err, "times": times, "work": work, "earlier": earlier,
            "steps": {name: steps_p if name == "subtree_decoder" else steps
                      for name in rows}, "by_shape": by_shape,
            "launched": {name: launched[name] for name in rows}}


def draw_phases(dev, card, ms) -> dict:
    """Phases 10-11: the caller's-decoder path, whose message, encode and
    noise come from the symbols, block-encoder and AWGN kernels, at
    Polar(1024, 512) B=32768 and Polar(131072, 65536) B=4096."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.ops.cuda import (channel_kernel, count_kernel,
                                          decoder_kernel, encode_kernel,
                                          front_kernel, step_kernel,
                                          subtree_kernel)
    from polar_tpu_torch.utils.benchmark import measure_step_rate
    from polar_tpu_torch.utils.cost import bound, row_work

    new = ("channel_symbols", "channel_awgn", "block_encoder")
    err = dict.fromkeys(new, 0)
    by_shape = {name: {} for name in new}   # name -> shape -> numbers
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def words(rows, cols):
        return torch.randint(0, 2**32, (rows, cols), generator=gen,
                             dtype=torch.int64, device=dev)

    def max_err(got, want):
        return int((got.int() - want.int()).abs().max())

    # -- 10. each kernel against its plain version, then timed, at the
    # shapes that both configurations of phase 11 give them; the large one
    # last, whose codeword the noise moments below use -----------------------
    shapes = []
    for m, b in DRAW_SHAPES:
        code = pt.make_code(m, rate=0.5)
        n, k = code.N, code.K
        where = f"Polar({n}, {k}) B={b}"
        shapes.append(where)
        kw = dict(seeds=(101, 202), call=0, device=dev)
        w = words(b, k)
        sym = {"native": lambda: channel_kernel.symbols((b, k), **kw),
               "bits": lambda: channel_kernel.symbols(words=w)}
        for mode, p in (
                ("native", lambda: channel_kernel.symbols_plain((b, k), **kw)),
                ("bits", lambda: channel_kernel.symbols_plain(words=w))):
            got = sym[mode]()
            e = max_err(got, p())
            err["channel_symbols"] = max(err["channel_symbols"], e)
            phase("10", f"symbols {mode} {(b, k)}: max abs err {e} against "
                  f"plain")
            if e:
                raise AssertionError(f"symbols kernel ({mode}) differs from "
                                     f"plain at {(b, k)}")
        # bits mode is no main-path launch: timed for the record
        bits_bound = bound(*row_work("channel_symbols", n=n, k=k, b=b,
                                     bits=True))[0]
        phase("10", f"symbols bits {(b, k)}: kernel "
              f"{ms_dropped(sym['bits'], 20):.4f} ms, bound "
              f"{bits_bound:.4f} ms (bytes) ({card})")
        del w, got
        by_shape["channel_symbols"][where] = {
            "ms": ms_dropped(sym["native"], 20),
            "plain_ms": ms(lambda: channel_kernel.symbols_plain((b, k), **kw),
                           2),
            "work": row_work("channel_symbols", n=n, k=k, b=b)}
        # the device's own time, which the host's launch rate hides in the
        # timing loop at the small shape
        phase("10", f"symbols native {(b, k)} device time (profiler): "
              f"kernel {profiled_ms(sym['native'], 20)} ({card})")

        cw = (1 - 2 * torch.randint(0, 2, (b, n), generator=gen,
                                    device=dev)).to(torch.int8)
        w1, w2 = words(b, n), words(b, n)
        for snr in (-1.5, 3.0):
            params = snr_params(snr)
            for mode, kw in (("native", dict(seeds=(303, 404), call=1)),
                             ("bits", dict(words=(w1, w2)))):
                got = channel_kernel.awgn(cw, params, **kw)
                want = channel_kernel.awgn_plain(cw, params, **kw)
                e = max_err(got, want)
                moved = int((got != want).sum())
                err["channel_awgn"] = max(err["channel_awgn"], e)
                phase("10", f"awgn {mode} {(b, n)} at {snr:+.1f} dB: max abs "
                      f"err {e} against plain ({moved} of {got.numel()} LLRs "
                      f"moved), {int((got == 0).sum())} zero LLRs")
                if e:
                    raise AssertionError(f"AWGN kernel ({mode}) differs from "
                                         f"plain at {(b, n)}")
                del got, want
        del w1, w2
        params = snr_params(-1.5)
        kw = dict(seeds=(7, 8), call=0)
        by_shape["channel_awgn"][where] = {
            "ms": ms_dropped(lambda: channel_kernel.awgn(cw, params, **kw),
                             20),
            "plain_ms": ms(lambda: channel_kernel.awgn_plain(
                cw, params, **kw), 2),
            "work": row_work("channel_awgn", n=n, k=k, b=b)}

        msg = channel_kernel.symbols((b, k), seeds=(m, 1), device=dev)
        for systematic in (True, False):
            ref = (pt.encode_systematic if systematic else pt.encode)(code, msg)
            levels = sorted({2, m - 7, encode_kernel.BLOCK_LEVEL, m}
                            & set(range(1, m + 1)))
            for bl in levels:
                enc = functools.partial(encode_kernel.make_encoder, code,
                                        systematic=systematic, block_level=bl)
                got = enc()(msg)
                plain = encode_kernel.encode_plain(code, msg, systematic, 1 << bl)
                e = max(max_err(got, plain), max_err(got, ref))
                err["block_encoder"] = max(err["block_encoder"], e)
                if e:
                    raise AssertionError(f"encoder differs at m={m} block "
                                         f"level {bl} sys={systematic}")
            phase("10", f"block encoder {where} sys={systematic}: == plain "
                  f"and == encode{'_systematic' if systematic else ''} at "
                  f"block levels {levels} (max abs err 0)")
        blk = 1 << min(encode_kernel.BLOCK_LEVEL, m)
        enc = encode_kernel.make_encoder(code)
        by_shape["block_encoder"][where] = {
            "ms": ms_dropped(lambda: enc(msg), 20),
            "plain_ms": ms(lambda: encode_kernel.encode_plain(
                code, msg, True, blk), 2),
            "work": row_work("block_encoder", n=n, k=k, b=b)}
        del msg, ref, got, plain
        for name in new:
            t = by_shape[name][where]
            phase("10", f"{name}: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.3f} ms at {where} ({card})")
    # native normals through the kernel itself: cw = 0, sigma = 1, scale 16
    q = channel_kernel.awgn(torch.zeros_like(cw), (1.0, 16.0), seeds=(5, 5))
    z = q.double() / 16.0
    mean, std = float(z.mean()), float(z.std())
    # |z| > 3 on the 1/16 grid is |16 n| > 48.5 (ties round to the even 48)
    tail, kurt = float((z.abs() > 3.0).double().mean()), float((z**4).mean())
    p_tail = math.erfc(48.5 / 16 / math.sqrt(2))
    phase("10", f"native normals ({q.numel()} through the kernel, 1/16 "
          f"steps): mean {mean:.5f} std {std:.5f} P(|n|>3.03) {tail:.6f} "
          f"(normal law {p_tail:.6f}) E[n^4] {kurt:.4f}")
    # within 5 standard errors; the 1/16 grid adds 1/(12 * 256) to the
    # variance and about 0.002 to E[n^4]
    se = 5 / math.sqrt(q.numel())
    if not (abs(mean) < se and abs(std**2 - 1 - 1 / 3072) < se * math.sqrt(2)
            and abs(kurt - 3) < se * math.sqrt(96) + 0.003
            and abs(tail - p_tail) < se * math.sqrt(p_tail)):
        raise AssertionError("native AWGN normals off their moments")
    del q, z, cw

    # -- 11. the path: pinned decoders with the kernel draws -----------------
    configs = []
    for m, b in DRAW_SHAPES:
        code = pt.make_code(m, rate=0.5)
        dec, desc = pt.make_auto_decoder(code, output="systematic", device=dev)
        configs.append((code, b, dec, desc))
    for code, b, dec, desc in configs:
        body = pt.ber.make_step_body(code, decoder=dec, rng="kernel-bits",
                                     device=dev)
        ws = (words(b, code.K), words(b, code.N), words(b, code.N))
        got = {k: int(v) for k, v in body(None, -1.5, b, words=ws).items()}
        msg = channel_kernel.symbols_plain(words=ws[0])
        cw = pt.encode_systematic(code, msg)
        llr = channel_kernel.awgn_plain(cw, snr_params(-1.5), words=ws[1:])
        want = {k: int(v) for k, v in pt.ber.frame_counters(
            msg, cw, llr, dec(llr)).items()}
        if got != want:
            raise AssertionError(f"kernel-draw step {got} vs torch-draw step "
                                 f"{want} at Polar({code.N}, {code.K})")
        phase("11", f"Polar({code.N}, {code.K}) B={b} ({desc}), injected "
              f"words at -1.5 dB: kernel-draw step == torch-draw step "
              f"{list(got.values())}")
        del ws, msg, cw, llr

    # the main path, one campaign per shape, each with its counts reset
    # just before it: the launches of rows 10-12 by shape, and the steps
    # that made them
    counts = (channel_kernel.launches, encode_kernel.launches,
              decoder_kernel.launches, subtree_kernel.launches,
              step_kernel.launches, front_kernel.launches,
              count_kernel.launches)
    plains = (channel_kernel.plain_calls, encode_kernel.plain_calls,
              decoder_kernel.plain_calls, subtree_kernel.plain_calls)
    results, launched, wall = [], dict.fromkeys(new, 0), 0.0
    for (code, b, dec, _), snr_range, where in zip(
            configs, ((-1.0, 0.0), (-1.7, -1.4)), shapes):
        _reset(*counts, *plains)
        t0 = time.perf_counter()
        res = pt.run_campaign(
            code, device=dev, decoder=dec, seed=11, batch=b, steps_per_call=4,
            snr_range=snr_range, snr_step=0.2 if code.level == 10 else 0.1,
            max_frames_per_point=4 * b, measure_throughput=False)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        results.append(res)
        here = {name: v for c in counts for name, v in c.items()}
        plain = {name: v for c in plains for name, v in c.items()}
        steps = sum(p.frames for p in res.points) // b
        if (min(here[name] for name in new) == 0 or max(plain.values())
                or here["channel_symbols"] != steps):
            raise AssertionError(f"pinned-decoder campaign at {where}: "
                                 f"launches {here} in {steps} steps, plain "
                                 f"calls {plain}")
        for name in new:
            by_shape[name][where].update(launches=here[name], steps=steps)
            launched[name] += here[name]
        phase("11", f"campaign with a pinned decoder at {where}, 4 steps per "
              f"call: {len(res.points)} points, {steps} steps; launches "
              f"{here}; plain calls {plain}")
    phase("11", f"campaigns with pinned decoders in {wall:.1f} s")
    campaign_vs_reference("11", results[0], "n1024_sys_int8.json", 512,
                          len(results[0].points))
    campaign_vs_reference("11", results[1], "n131072_sys_int8.json",
                          1 << (LARGE_M - 1), 3)

    for code, b, dec, desc in configs:
        g = torch.Generator()
        g.manual_seed(code.level)
        large = code.level > 10
        kw = (dict(device=dev, iters=8, repeats=2, warmup=False, max_iters=32)
              if large else dict(device=dev, iters=16, max_iters=256))
        rates = {}
        for label, fused in (("torch", False), ("kernel", "auto"), ("kernel", "auto"),
                             ("torch", False)):
            step = pt.make_step(code, decoder=dec, fused=fused, device=dev)
            rates.setdefault(label, []).append(
                measure_step_rate(step, g, -1.5, b, **kw))
        phase("11", f"step rate Polar({code.N}, {code.K}) B={b} ({desc}), "
              f"frames/s: kernel draws {rates['kernel']}, torch draws "
              f"{rates['torch']} (order torch, kernel, kernel, torch; {card})")

    code = configs[0][0]
    llr = torch.randint(-128, 128, (256, code.N), generator=gen, device=dev,
                        dtype=torch.int8)
    sc = pt.make_sc_decoder(code, output="both")
    got, want = sc(llr), sc(llr.cpu())
    if not all(torch.equal(a.cpu(), b_) for a, b_ in zip(got, want)):
        raise AssertionError("SC decoder on the card differs from the CPU")
    phase("11", f"SC decoder Polar({code.N}, {code.K}) B=256 full-range "
          "int8: u and codeword on the card == on the CPU")
    return {"err": err,
            "times": {name: (by_shape[name][shapes[-1]]["ms"],
                             by_shape[name][shapes[-1]]["plain_ms"])
                      for name in new},
            "work": {name: by_shape[name][shapes[-1]]["work"] for name in new},
            "steps": {name: sum(t["steps"] for t in by_shape[name].values())
                      for name in new},
            "by_shape": by_shape, "launched": launched}


def front_step_phases(dev, card, ms) -> dict:
    """Phase 12: the element-major front step. The whole-block front,
    decode+count and the middle-stages kernel against their plain
    versions, the first two also against the kernels they replaced; the
    front chains against the fused step on the same seeds at every level
    2..16; the large-N step with either middle; chained campaigns through
    make_step's default path at B = 4096 at Polar(1024, 512) (the fused
    step) and Polar(4096, 2048) up to Polar(16384, 8192) (the block front)
    against the JAX package's results, and the front path's own run
    (make_step's default at Polar(256, 128), B = BATCH: the whole branch)
    against its result file;
    timings at the shapes those runs launch, rows 6 and 8 in turns with
    the kernels they replaced."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.ops.cuda import (channel_kernel, count_kernel,
                                          decoder_kernel, encode_kernel,
                                          front_kernel, step_kernel,
                                          subtree_kernel, tile_stages)
    from polar_tpu_torch.utils.cost import bound, row_work

    new = ("front_whole", "decode_count", "front_middle")
    err = dict.fromkeys(new, 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def symbols(rows, batch):
        return (1 - 2 * torch.randint(0, 2, (rows, batch), generator=gen,
                                      device=dev)).to(torch.int8)

    def max_err(got, want):
        return max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))

    def check(name, got, want, what):
        e = max_err(got, want)
        err[name] = max(err[name], e)
        phase("12", f"{what}: max abs err {e}")
        if e:
            raise AssertionError(f"{name} differs from its plain version: {what}")

    # -- the whole-block front and decode+count against their plain versions
    # and the kernels they replaced (styles "thread" and "walk")
    params = snr_params(-1.5)
    # front_m at BATCH is the shape the front path's run below launches and
    # the timings take; m = 12 at LARGE_BATCH the other timed shape
    front_m = FRONT_PATH_M
    ties = torch.tensor((-128, -127, -1, 0, 1, 127), dtype=torch.int8,
                        device=dev)
    for m, b in ((front_m, BATCH), (10, BATCH), (12, LARGE_BATCH),
                 (13, LARGE_BATCH), (14, LARGE_BATCH)):
        code = pt.make_code(m, rate=0.5)
        program = pt.compile_program(code)
        desc = f"Polar({code.N}, {code.K}) B={b}"
        for mode, kw in (("inject", dict(msg_t=symbols(code.N, b),
                                         normals_t=torch.randn(
                                             (code.N, b), generator=gen,
                                             device=dev))),
                         ("native", dict(seeds=(m, 12), call=2, batch=b,
                                         device=dev))):
            got = step_kernel.front(code.frozen, params, **kw)
            want = step_kernel.front_plain(code.frozen, params, **kw)
            old = step_kernel.front(code.frozen, params, style="thread", **kw)
            check("front_whole", got, want, f"whole front "
                  f"({step_kernel.front_kernel_name(code.N)}) {mode} {desc}, "
                  f"{int((got[0] != want[0]).sum())} of {code.N * b} LLRs "
                  "moved")
            check("front_whole", got, old, f"whole front {mode} {desc} == "
                  "style thread")
            del kw, want, old
        llr_full = torch.randint(-128, 128, (code.N, b), generator=gen,
                                 device=dev, dtype=torch.int8)
        assert bool((llr_full == -128).any()), "LLRs must include -128"
        llr_ties = ties[torch.randint(0, len(ties), (code.N, b), generator=gen,
                                      device=dev)]
        for label, (llr, cw) in (("the front's outputs", got),
                                 ("full-range int8 LLRs", (llr_full, got[1])),
                                 ("tie-heavy LLRs", (llr_ties, got[1]))):
            a = step_kernel.decode_count(program, code.frozen, llr, cw)
            w = step_kernel.decode_count_plain(program, code.frozen, llr, cw)
            o = step_kernel.decode_count(program, code.frozen, llr, cw,
                                         style="walk")
            check("decode_count", [a, a], [w, o],
                  f"decode+count ({decoder_kernel.ssa_kernel(code.N)}) {desc} "
                  f"on {label}: {a.tolist()} == plain == style walk")
        del got, llr_full, llr_ties

    # -- every front branch counts what the fused step counts, at every level
    for level in range(pt.ber.STEP_KERNEL_MIN_LEVEL,
                       pt.ber.STEP_KERNEL_MAX_LEVEL + 1):
        lc = pt.make_code(level, rate=0.5)
        kw = dict(seeds=(level, 77), call=0, batch=1024, device=dev)
        for systematic in (True, False):
            want = step_kernel.step(pt.compile_program(lc), lc.frozen,
                                    snr_params(-1.0), systematic, **kw)
            for branch in (pt.ber.FRONT_BRANCHES if systematic
                           else ("block-whole", "block-hybrid")):
                got = pt.ber.make_front_chain(lc, systematic=systematic,
                                              branch=branch)(
                    snr_params(-1.0), **kw)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{branch} chain {got.tolist()} vs fused step "
                        f"{want.tolist()} at m={level} sys={systematic}")
    phase("12", f"front branches {list(pt.ber.FRONT_BRANCHES)} (systematic) "
          "and block-whole, block-hybrid (plain), kernel middle, == fused "
          "step on the same seeds at every level "
          f"{pt.ber.STEP_KERNEL_MIN_LEVEL}..{pt.ber.STEP_KERNEL_MAX_LEVEL}, "
          "B=1024")

    # -- the middle kernel at the shape of each campaign below that takes the
    # block front (systematic, blocks blk/blk) and at the large code, and
    # the large-N step with it
    blk = 1 << front_kernel.BLOCK_LEVEL
    paths = {m: pt.ber._step_path(pt.make_code(m, rate=0.5), torch.int8, None,
                                  None, "auto", dev, batch=LARGE_BATCH)
             for m, _, _ in CAMPAIGNS}
    middle_ms = [m for m, path in paths.items() if path == "front"]
    if not middle_ms:
        raise AssertionError(f"no campaign takes the block front: {paths}")
    for m, pairs in ([(m, ((blk, blk),)) for m in middle_ms]
                     + [(LARGE_M, ((1 << 10, 1 << 10), (1 << 10, 1 << 8),
                                   (1 << 6, 1 << 12)))]):
        code = pt.make_code(m, rate=0.5)
        n, b = code.N, LARGE_BATCH
        x = symbols(n, b)
        if m == middle_ms[0]:
            middle_x = x    # the shape the timings below take
        for systematic in (True, False):
            for ba, bb in pairs:
                got = front_kernel.middle_kernel(x, code.frozen, ba, bb,
                                                 systematic)
                want = front_kernel.middle_plain(x, code.frozen, ba, bb,
                                                 systematic)
                check("front_middle", [got], [want],
                      f"middle kernel ({n}, {b}) sys={systematic} blocks "
                      f"{ba}/{bb}, {len(front_kernel.middle_passes(n, ba, bb, systematic))} pass(es)")
                del got, want
    kw = dict(seeds=(17, 12), call=0, batch=2048, device=dev)
    counted = [pt.ber.make_front_chain(code, middle_mode=mode)(snr_params(-1.4),
                                                               **kw).tolist()
               for mode in ("kernel", "torch")]
    if counted[0] != counted[1]:
        raise AssertionError(f"large-N step, kernel middle {counted[0]} vs "
                             f"torch middle {counted[1]}")
    phase("12", f"large-N step Polar({n}, {code.K}) B=2048 "
          f"({pt.ber.front_branch(code, True)}): kernel middle == torch "
          f"middle on the same seeds: {counted[0]}")

    # -- the main path: chained campaigns through make_step's default path
    counts = (step_kernel.launches, front_kernel.launches,
              decoder_kernel.launches, subtree_kernel.launches,
              count_kernel.launches, channel_kernel.launches,
              encode_kernel.launches)
    plains = (step_kernel.plain_calls, front_kernel.plain_calls,
              decoder_kernel.plain_calls, subtree_kernel.plain_calls,
              count_kernel.plain_calls, channel_kernel.plain_calls,
              encode_kernel.plain_calls)
    olds = (step_kernel.earlier_launches,)
    _reset(*counts, *plains, *olds)
    t0 = time.perf_counter()
    results, front_launches = [], {}
    for m, snr_range, step in CAMPAIGNS:
        before = {**front_kernel.launches, **count_kernel.launches}
        results.append(pt.run_campaign(
            pt.make_code(m, rate=0.5), device=dev, seed=m, batch=LARGE_BATCH,
            steps_per_call=4, snr_range=snr_range, snr_step=step,
            max_frames_per_point=4 * LARGE_BATCH, measure_throughput=False))
        after = {**front_kernel.launches, **count_kernel.launches}
        front_launches[m] = {name: after[name] - before[name]
                             for name in ("front_blocks_a", "front_blocks_b",
                                          "count", "front_middle")}
    gen_front = torch.Generator()
    gen_front.manual_seed(10)
    front_code = pt.make_code(front_m, rate=0.5)
    front_path = (pt.ber._step_path(front_code, torch.int8, None, None,
                                    "auto", dev, True, BATCH),
                  pt.ber.front_branch(front_code, True))
    if front_path != ("front", "whole"):
        raise AssertionError(f"make_step's default at Polar({front_code.N}, "
                             f"{front_code.K}) B={BATCH} is {front_path}, not "
                             "the front's whole branch")
    before = dict(step_kernel.launches)
    front_res = pt.run_point(front_code, -1.0, gen=gen_front, batch=BATCH,
                             steps_per_call=4, max_frames=8 * BATCH,
                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the front path's own launches: the row-word front and the tile
    # decode+count, a launch each a step
    front_steps = front_res.frames // BATCH
    front_run = {name: step_kernel.launches[name] - before[name]
                 for name in ("front_whole", "decode_count")}
    launched = {name: v for c in counts for name, v in c.items()}
    plain = {name: v for c in plains for name, v in c.items()}
    old = {name: v for c in olds for name, v in c.items()}
    if (min(launched[name] for name in new) == 0 or max(plain.values()) != 0
            or max(old.values()) or not all(
                min(front_launches[m].values()) > 0 for m in middle_ms)
            or set(front_run.values()) != {front_steps}):
        raise AssertionError(f"front-step campaigns launches {launched}, "
                             f"plain calls {plain}, old-style launches {old}, "
                             f"front path {front_run} in {front_steps} steps")
    phase("12", f"campaigns at m = {[m for m, _, _ in CAMPAIGNS]} through "
          f"make_step (paths {paths}), and the front path (make_step's "
          f"default, {front_path}) at "
          f"Polar({front_code.N}, {front_code.K}) B={BATCH}: "
          f"{front_res.frames} frames, BER {front_res.ber:.4g}, its launches "
          f"{front_run} in {front_steps} steps; {wall:.1f} s; "
          f"launches {launched}; plain calls {plain}; old-style launches "
          f"{old}")
    for (m, _, _), res in zip(CAMPAIGNS, results):
        campaign_vs_reference("12", res, f"n{1 << m}_sys_int8.json",
                              1 << (m - 1), len(res.points))
    campaign_vs_reference(
        "12", pt.ber.CampaignResult(front_code.N, front_code.K, True,
                                    [front_res]),
        f"n{front_code.N}_sys_int8.json", front_code.K, 1)
    # the middle kernel's launches come from the campaigns on the block front
    middle_steps = sum(p.frames for (m, _, _), res in zip(CAMPAIGNS, results)
                       if paths[m] == "front" for p in res.points) // LARGE_BATCH

    # -- timings at the shapes of the path
    times, work, earlier = {}, {}, {}
    by_shape = {"front_blocks_a": {}, "front_blocks_b": {}, "count": {},
                "front_whole": {}, "decode_count": {}}
    # the row-word front and the tile decode+count in turns with the kernels
    # they replaced (native words), with the profiler's device time: at the
    # front path's shape (its launches), at Polar(4096, 2048), B = 4096, and
    # decode+count at Polar(1024, 512), B = BATCH
    for m, b, names in ((front_m, BATCH, ("front_whole", "decode_count")),
                        (12, LARGE_BATCH, ("front_whole", "decode_count")),
                        (10, BATCH, ("decode_count",))):
        code = pt.make_code(m, rate=0.5)
        program = pt.compile_program(code)
        where = f"Polar({code.N}, {code.K}) B={b}"
        kw = dict(seeds=(9, 9), call=0, batch=b, device=dev)
        llr, cw = step_kernel.front(code.frozen, params, **kw)
        fns = {
            "front_whole": (
                lambda st: step_kernel.front(code.frozen, params, style=st,
                                             **kw), ("rows", "thread"),
                lambda: step_kernel.front_plain(code.frozen, params, **kw),
                row_work("front_whole", n=code.N, k=code.K, b=b)),
            "decode_count": (
                lambda st: step_kernel.decode_count(program, code.frozen, llr,
                                                    cw, style=st),
                ("ssa", "walk"),
                lambda: step_kernel.decode_count_plain(program, code.frozen,
                                                       llr, cw),
                row_work("decode_count", n=code.N, k=code.K, b=b))}
        main = (m, b) == (front_m, BATCH)
        # decode+count's decode alone: the whole-code tile decoder on the
        # same cw track (it also stores the message and the estimate)
        decode_ms = ms(lambda: decoder_kernel.decode(program, code.frozen, llr,
                                                     True), 20)
        for name in names:
            fn, (new_st, old_st), plain_fn, w = fns[name]
            t = in_turns(lambda: fn(new_st), lambda: fn(old_st), 20)
            dev_ms = [profiled_ms(lambda: fn(st), 20)
                      for st in (new_st, old_st)]
            by_shape[name][where] = {
                **t, "plain_ms": ms(plain_fn, 2),
                "launches": front_run[name] if main else 0,
                "steps": front_steps if main else 0, "work": w}
            phase("12", f"{name} at {where}: kernel {t['ms']:.4f} ms, "
                  f"earlier (style {old_st}) {t['earlier_ms']:.4f} ms "
                  f"({t['turns']}), plain "
                  f"{by_shape[name][where]['plain_ms']:.3f} ms; device time "
                  f"(profiler) {dev_ms[0]}, style {old_st} {dev_ms[1]}; "
                  f"{by_shape[name][where]['launches']} launches on the "
                  f"front path"
                  + (f"; the cw-track tile decoder alone {decode_ms:.4f} ms; "
                     + stages(tile_stages.program_stages(
                         program, tile_stages.block_rows(2, 2), True))
                     if name == "decode_count" else "") + f" ({card})")
            if main:
                times[name] = (t["ms"], by_shape[name][where]["plain_ms"])
                earlier[name] = t["earlier_ms"]
                work[name] = w
        del llr, cw, fns
    mc = pt.make_code(middle_ms[0], rate=0.5)
    n, b = middle_x.shape
    times["front_middle"] = (
        ms(lambda: front_kernel.middle_kernel(middle_x, mc.frozen, blk, blk,
                                              True), 20),
        ms(lambda: front_kernel.middle_plain(middle_x, mc.frozen, blk, blk,
                                             True), 3))
    work["front_middle"] = row_work("front_middle", n=n, b=b, level=mc.level)
    # row 9s at each shape the main path launches it (the campaigns on the
    # block front, systematic, blocks blk/blk): CUDA events around the
    # wrapper (its host work included) and the profiler's device time
    by_shape["front_middle"] = {}
    for m in middle_ms:
        fc = pt.make_code(m, rate=0.5)
        x = symbols(fc.N, LARGE_BATCH)
        where = f"Polar({fc.N}, {fc.K}) B={LARGE_BATCH}"
        steps_m = sum(p.frames for p in results[[c[0] for c in CAMPAIGNS]
                                                .index(m)].points) // LARGE_BATCH
        mid = lambda: front_kernel.middle_kernel(  # noqa: E731
            x, fc.frozen, blk, blk, True)
        t_ev = ms(mid, 20)
        dev_ms = profiled_ms(mid, 20)
        w = row_work("front_middle", n=fc.N, b=LARGE_BATCH, level=fc.level)
        by_shape["front_middle"][where] = {
            "ms": t_ev,
            "device_ms": (float(dev_ms.split()[0]) if dev_ms.endswith(" ms")
                          else None),
            "plain_ms": ms(lambda: front_kernel.middle_plain(
                x, fc.frozen, blk, blk, True), 2),
            "launches": front_launches[m]["front_middle"], "steps": steps_m,
            "work": w}
        phase("12", f"front_middle at {where}: events {t_ev:.4f} ms, device "
              f"time (profiler) {dev_ms}, bound {bound(*w)[0]:.4f} ms, "
              f"{len(front_kernel.middle_passes(fc.N, blk, blk, True))} "
              f"pass(es), {front_launches[m]['front_middle']} launches in "
              f"{steps_m} steps ({card})")
        del x
    # kernels A and B at the shape of each campaign on the block front, and
    # their launches there
    for m in middle_ms:
        fc = pt.make_code(m, rate=0.5)
        where = f"Polar({fc.N}, {fc.K}) B={LARGE_BATCH}"
        steps_m = sum(p.frames for p in results[[c[0] for c in CAMPAIGNS]
                                                .index(m)].points) // LARGE_BATCH
        kw = dict(seeds=(m, 5), call=0)
        blk_a = 1 << min(front_kernel.BLOCK_LEVEL, m)
        blk_b = 1 << min(front_kernel.CHAN_BLOCK_LEVEL, m)
        x = front_kernel.msg_blocks(fc.frozen, blk_a, True, batch=LARGE_BATCH,
                                    device=dev, **kw)
        y = front_kernel.middle_kernel(x, fc.frozen, blk_a, blk_b, True)
        for name, fn, plain_fn in (
                ("front_blocks_a", lambda: front_kernel.msg_blocks(
                    fc.frozen, blk_a, True, batch=LARGE_BATCH, device=dev,
                    **kw),
                 lambda: front_kernel.msg_blocks_plain(
                     fc.frozen, blk_a, True, batch=LARGE_BATCH, device=dev,
                     **kw)),
                ("front_blocks_b", lambda: front_kernel.chan_blocks(
                    y, blk_b, params, **kw),
                 lambda: front_kernel.chan_blocks_plain(y, blk_b, params,
                                                        **kw))):
            t = {"ms": ms_dropped(fn, 20)}
            by_shape[name][where] = {
                **t, "plain_ms": ms(plain_fn, 2),
                "launches": front_launches[m][name], "steps": steps_m,
                "work": row_work(name, n=fc.N, k=fc.K, b=LARGE_BATCH)}
            phase("12", f"{name} at {where}: kernel {t['ms']:.4f} ms, plain "
                  f"{by_shape[name][where]['plain_ms']:.3f} ms; "
                  f"{front_launches[m][name]} launches in {steps_m} steps "
                  f"({card})")
        del x, y
        # the counter at the campaign's shape (systematic campaigns on the
        # block front count each step)
        args = count_inputs(gen, fc.N, LARGE_BATCH, dev)
        count = lambda: count_kernel.count(fc.frozen, *args)  # noqa: E731
        t = {"ms": ms_dropped(count, 20)}
        by_shape["count"][where] = {
            **t, "plain_ms": ms(lambda: count_kernel.count_plain(
                fc.frozen, *args), 2),
            "launches": front_launches[m]["count"], "steps": steps_m,
            "work": row_work("count", n=fc.N, k=fc.K, b=LARGE_BATCH)}
        phase("12", f"count at {where}: kernel {t['ms']:.4f} ms, plain "
              f"{by_shape['count'][where]['plain_ms']:.3f} ms; "
              f"{front_launches[m]['count']} launches in {steps_m} steps; "
              f"device time (profiler) {profiled_ms(count, 20)} ({card})")
        del args
    t_k, t_p = times["front_middle"]
    phase("12", f"front_middle: kernel {t_k:.3f} ms, plain {t_p:.3f} ms at "
          f"({n}, {b}) systematic, blocks {blk}/{blk} ({card})")
    return {"err": err, "times": times, "work": work, "by_shape": by_shape,
            "earlier": earlier,
            "steps": {"front_middle": middle_steps,
                      "front_whole": front_steps, "decode_count": front_steps},
            "launched": {name: launched[name] for name in new}}


def style_phases(dev, card, ms) -> dict:
    """Phase 14: the decoder's scratch and interpreter styles. The scratch
    whole-code kernel (the tile kernel at scratch_shape's shapes) against
    the golden vectors (m = 2..11), its plain version and the SSA kernel,
    at every level 1..11 and batch class of its shape table; the scratch
    and interpreter subtree kernels against their plain versions in every
    distinct kernel node of the hybrid kl9 at Polar(131072, 65536), the
    scratch one also at B = 4096 and 16384; the hybrid in each style
    against the SSA hybrid; the
    interpreter decoder against the SSA whole-code kernel and the SSA
    hybrid; interpreter decode+count against its plain version and the
    block-interp chain against block-hybrid; the slice's main path (pinned
    decoders and the block-interp front step, counts reset just before);
    make_step's default path at plain Polar(32768, 16384), B = 4096 (the
    interpreter's tile kernel; counts reset just before) and its decoder
    against the plain one; timings of the scratch kernels and rows 13-15
    beside their plain versions."""
    import numpy as np
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.code.compiler import emit_program
    from polar_tpu_torch.decode import auto
    from polar_tpu_torch.decode.auto import make_kernel_decoder
    from polar_tpu_torch.ops.cuda import (channel_kernel, count_kernel,
                                          decoder_kernel, encode_kernel,
                                          front_kernel, interp_kernel,
                                          step_kernel, subtree_kernel)
    from polar_tpu_torch.ops.cuda.interp_kernel import (
        make_interp_decode_count, make_interp_decoder, make_interp_subtree)
    from polar_tpu_torch.utils.cost import row_work

    new = ("scratch_decoder", "scratch_subtree", "interp_decoder",
           "interp_decode_count", "interp_subtree")
    err = dict.fromkeys(new, 0)
    programs = {}   # each interpreter program launched: its schedule, grid
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)

    def rand_i8(rows, batch):
        x = torch.randint(-128, 128, (rows, batch), generator=gen, device=dev,
                          dtype=torch.int8)
        assert bool((x == -128).any()) and bool((x == 0).any())
        return x

    def edge_i8(rows, batch):
        """Full-range int8, column 0 all -128, column 1 all 0."""
        x = torch.randint(-128, 128, (rows, batch), generator=gen, device=dev,
                          dtype=torch.int8)
        x[:, 0] = -128
        x[:, 1:2] = 0
        return x

    def check(name, got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} outputs, {len(want)} "
                                 f"expected: {what}")
        e = max(int((g.int() - w.int()).abs().max()) if g.numel() else 0
                for g, w in zip(got, want))
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} differs: {what}")

    # -- the scratch whole-code kernel: golden vectors, plain, SSA ----------
    with np.load(ROOT / "tests" / "vectors" / "golden.npz") as z:
        vec = dict(z.items())
    batches, levels = 0, set()
    for key in sorted(vec):
        if not key.startswith("mask_"):
            continue
        _, m, rk = key.split("_")
        if int(m) > decoder_kernel.SCRATCH_MAX_LEVEL:
            continue
        gcode = pt.PolarCode(int(m), vec[key])
        program = pt.compile_program(gcode)
        i = 0
        while f"llr_{m}_{rk}_{i}" in vec:
            llr_t = torch.from_numpy(vec[f"llr_{m}_{rk}_{i}"].T.copy()).to(dev)
            got, _ = decoder_kernel.decode(program, gcode.frozen, llr_t, False,
                                           "scratch")
            want, _ = decoder_kernel.decode_plain(program, gcode.frozen, llr_t,
                                                  False)
            gold = torch.from_numpy(vec[f"dec_{m}_{rk}_{i}"].T.copy()).to(dev)
            check("scratch_decoder", got, want, f"golden m={m} rate={rk}")
            check("scratch_decoder", got, gold, f"golden m={m} rate={rk}")
            batches += 1
            levels.add(int(m))
            i += 1
    phase("14", f"scratch decoder == plain == {batches} "
          f"golden dec_* batches (m={min(levels)}..{max(levels)}, max abs "
          "err 0)")
    # every cell of the shape table: each level, a batch of each class
    picked = set()
    for level in range(1, decoder_kernel.SCRATCH_MAX_LEVEL + 1):
        lc = pt.make_code(level, rate=0.5)
        lp = pt.compile_program(lc)
        for bt in SCRATCH_BATCHES:
            x = edge_i8(lc.N, bt)
            got, _ = decoder_kernel.decode(lp, lc.frozen, x, False, "scratch")
            what = f"Polar({lc.N}, {lc.K}) B={bt}"
            check("scratch_decoder", got,
                  decoder_kernel.decode_plain(lp, lc.frozen, x, False)[0],
                  f"{what} against plain")
            picked.add(decoder_kernel.scratch_shape(level, bt))
    phase("14", f"scratch tile kernel == plain at every "
          f"level 1..{decoder_kernel.SCRATCH_MAX_LEVEL} and B in "
          f"{SCRATCH_BATCHES}, full-range int8: (wr, vw, warps) picked "
          f"{sorted(picked)} (max abs err 0)")
    code = pt.make_code(10, rate=0.5)
    program = pt.compile_program(code)
    llr_t = rand_i8(code.N, BATCH)
    got, _ = decoder_kernel.decode(program, code.frozen, llr_t, False, "scratch")
    check("scratch_decoder", got,
          decoder_kernel.decode(program, code.frozen, llr_t, False)[0],
          "Polar(1024, 512) against the SSA kernel")
    check("scratch_decoder", got,
          decoder_kernel.decode_plain(program, code.frozen, llr_t, False)[0],
          "Polar(1024, 512) against plain")
    phase("14", f"scratch decoder == SSA kernel == plain at "
          f"Polar(1024, 512) B={BATCH}, full-range int8 (max abs err 0)")

    # -- the interpreter decoder against the SSA whole-code kernel ----------
    for output in ("u", "systematic", "codeword", "both"):
        ssa = make_kernel_decoder(code, output=output).lane_major(llr_t)
        for sl in (5, 10):
            dec = make_interp_decoder(code, subtree_level=sl, output=output)
            got = dec.lane_major(llr_t)
            check("interp_decoder", got, ssa,
                  f"Polar(1024, 512) sl{sl} {output}")
            if output != "systematic":
                check("interp_decoder", got, dec.plain(llr_t),
                      f"Polar(1024, 512) sl{sl} {output} against plain")
                programs[f"Polar(1024, 512) {output} sl{sl}"] = dec.plan(
                    BATCH)
    phase("14", f"interp decoder, tile kernel (subtree levels 5, 10) == SSA "
          f"whole-code kernel at Polar(1024, 512) B={BATCH}, "
          f"u/systematic/codeword/both, and == plain "
          f"(u/codeword/both) (max abs err 0; {dec.program_steps} steps, "
          f"{dec.program_branches} branches at sl10)")
    del llr_t, ssa, got

    # -- the large code: subtree kernels, hybrids, interpreter --------------
    big = pt.make_code(LARGE_M, rate=0.5)
    n, k, b = big.N, big.K, LARGE_BATCH
    kl = auto.hybrid_kernel_level(LARGE_M)
    tree = pt.compile_code(big)
    nodes, stack = {}, [tree]
    while stack:  # the hybrid's kernel nodes, one per distinct pattern
        node = stack.pop()
        if node.level <= kl and node.mesg_bits >= 1 and node.kind in (
                "branch", "rate0_right", "rate1_comb"):
            nodes.setdefault(emit_program(node, node.level).tobytes(), node)
            continue
        stack.extend(c for c in (node.left, node.right) if c is not None)
    for node in nodes.values():
        slot = rand_i8(1 << node.level, 1024)
        want_u = subtree_kernel.decode_plain(node, (slot,))
        want_cw = subtree_kernel.decode_plain(node, (slot,), emit_cw=True)
        check("scratch_subtree",
              subtree_kernel.make_subtree_decoder(node, style="scratch")(slot),
              want_u, f"{node.kind} level {node.level}")
        for sl in (5, 10):
            for emit_u in (True, False):
                kw = dict(emit_u=emit_u, emit_cw=True, subtree_level=sl)
                got = make_interp_subtree(node, **kw)(slot)
                check("interp_subtree", got,
                      want_cw if emit_u else want_cw[1:],
                      f"{node.kind} level {node.level} sl{sl} u={emit_u}")
        fn = make_interp_subtree(node)
        check("interp_subtree", fn(slot), want_u,
              f"{node.kind} level {node.level} u")
        plan = fn.plan(slot.shape[1])
        if plan["cooperative"]:
            raise AssertionError(f"a level-{node.level} node's program has "
                                 f"grid steps: {plan}")
    phase("14", f"scratch and interp (sl5, sl10; u, u+cw, cw) "
          f"subtree kernels == plain in all {len(nodes)} distinct kernel "
          f"nodes of the hybrid kl{kl} at Polar({n}, {k}), full-range int8 "
          "slots, B=1024 (max abs err 0); each node one tile run, a plain launch of "
          f"{plan['warps']} warps a block, {plan['blocks']} blocks at "
          f"B={slot.shape[1]}")
    for bt in (b, 16384):
        for node in nodes.values():
            slot = edge_i8(1 << node.level, bt)
            got = subtree_kernel.make_subtree_decoder(node, style="scratch")(
                slot)
            check("scratch_subtree", got,
                  subtree_kernel.decode_plain(node, (slot,)),
                  f"{node.kind} level {node.level} B={bt}")
    phase("14", f"scratch subtree kernel == plain in all "
          f"{len(nodes)} distinct kernel nodes at B={b} and 16384, shapes "
          f"{decoder_kernel.scratch_shape(kl, b)} and "
          f"{decoder_kernel.scratch_shape(kl, 16384)} (max abs err 0)")

    llr_t = rand_i8(n, b)
    for output in ("u", "systematic", "codeword", "both"):
        want = pt.make_fastssc_decoder(big, output=output,
                                       output_dtype=torch.int8,
                                       kernel_level=kl).lane_major(llr_t)
        for style in ("scratch", "interp"):
            hyb = pt.make_fastssc_decoder(big, output=output,
                                          output_dtype=torch.int8,
                                          kernel_level=kl, kernel_style=style)
            name = "scratch_subtree" if style == "scratch" else "interp_subtree"
            check(name, hyb.lane_major(llr_t), want, f"hybrid {style} {output}")
            if output == "both":
                frame = hyb(llr_t.t().contiguous())
                check(name, tuple(f.t() for f in frame), want,
                      f"hybrid {style} frame entry")
        if output in ("u", "codeword"):
            for sl in (5, 10):
                dec = make_interp_decoder(big, subtree_level=sl, output=output)
                got = dec.lane_major(llr_t)
                check("interp_decoder", got, want,
                      f"Polar({n}, {k}) sl{sl} {output}")
                programs[f"Polar({n}, {k}) {output} sl{sl}"] = dec.plan(b)
        del want
    phase("14", f"hybrid kl{kl} in the scratch and interp styles == SSA hybrid "
          f"at Polar({n}, {k}) B={b}, all outputs, lane and frame entries; "
          f"interp decoder (sl5, sl10) == SSA hybrid, u and codeword (max "
          "abs err 0)")

    params = snr_params(-1.5)
    llr_f, cw_f = front_kernel.front_blocks(big.frozen, params, True,
                                            seeds=(14, 1), call=0, batch=b,
                                            device=dev)
    count = make_interp_decode_count(big)
    got = count(llr_f, cw_f)
    check("interp_decode_count", got, count.plain(llr_f, cw_f),
          f"Polar({n}, {k}) on the block front's outputs")
    programs[f"Polar({n}, {k}) decode+count sl10"] = count.plan(b)
    phase("14", f"interp decode+count (tile kernel, then the counter) == "
          f"plain at Polar({n}, {k}) B={b} on the block "
          f"front's outputs: {got.tolist()} (max abs err 0)")
    kw = dict(seeds=(LARGE_M, 14), call=0, batch=2048, device=dev)
    counted = [pt.ber.make_front_chain(big, branch=br)(snr_params(-1.4),
                                                        **kw).tolist()
               for br in ("block-interp", "block-hybrid")]
    if counted[0] != counted[1]:
        raise AssertionError(f"block-interp {counted[0]} vs block-hybrid "
                             f"{counted[1]} at m={LARGE_M}")
    phase("14", f"m={LARGE_M}: block-interp chain == block-hybrid chain on the "
          f"same seeds, B=2048: {counted[0]}")
    programs[f"Polar({n}, {k}) decode+count sl10, B=2048"] = count.plan(2048)
    for what, plan in programs.items():
        phase("14", f"interp program {what}: {plan['steps']} steps, grid "
              f"level {plan['grid_level']}, {plan['grid_steps']} grid steps, "
              f"{plan['tile_runs']} tile runs, {plan['entries']} entries, "
              f"{plan['barriers']} grid barriers; {stages(plan)}; "
              + (f"cooperative grid of {plan['blocks']} blocks"
                 if plan["cooperative"] else f"plain grid of {plan['blocks']}"
                 " blocks")
              + f" x {plan['warps']} warps, {plan['smem']} B shared")

    # -- the main path of the slice, through the entry points ---------------
    counts = (decoder_kernel.launches, subtree_kernel.launches,
              interp_kernel.launches, step_kernel.launches,
              front_kernel.launches, count_kernel.launches,
              channel_kernel.launches, encode_kernel.launches)
    plains = (decoder_kernel.plain_calls, subtree_kernel.plain_calls,
              interp_kernel.plain_calls, step_kernel.plain_calls,
              front_kernel.plain_calls, count_kernel.plain_calls,
              channel_kernel.plain_calls, encode_kernel.plain_calls)
    runs = (
        (code, False, BATCH, make_kernel_decoder(code, style="scratch")),
        (code, True, BATCH, make_interp_decoder(code, output="systematic")),
        (big, True, b, pt.make_fastssc_decoder(
            big, output="systematic", output_dtype=torch.int8,
            kernel_level=kl, kernel_style="scratch")),
        (big, True, b, pt.make_fastssc_decoder(
            big, output="systematic", output_dtype=torch.int8,
            kernel_level=kl, kernel_style="interp")),
        (big, True, b, None))
    _reset(*counts, *plains)
    t0 = time.perf_counter()
    points = []
    for i, (c, systematic, batch, dec) in enumerate(runs):
        g = torch.Generator()
        g.manual_seed(140 + i)
        step = (pt.ber.make_front_step(c, branch="block-interp", device=dev)
                if dec is None else
                pt.make_step(c, systematic=systematic, decoder=dec, device=dev))
        points.append(pt.run_point(c, -1.5 if c is big else -0.5, gen=g,
                                   step=step, systematic=systematic,
                                   batch=batch, max_frames=batch, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {name: v for c in counts for name, v in c.items()}
    # row 3 counts the scratch kernel in both layouts: the step hands the
    # pinned u decoder (B, N) LLRs, which it launches frame-major (phase 17
    # times that launch); the by_shape entries below are element-major
    lanes_launched = launched["scratch_decoder"]
    launched["scratch_decoder"] += launched["scratch_decoder_frames"]
    plain = {name: v for c in plains for name, v in c.items()}
    if min(launched[name] for name in new) == 0 or max(plain.values()) != 0:
        raise AssertionError(f"style path launches {launched}, plain calls "
                             f"{plain}")
    for p in points:
        if not (np.isfinite(p.ber) and 0 <= p.ber <= 1 and p.frames > 0):
            raise AssertionError(f"style path point out of range: {p}")
    phase("14", "style path (run_point: scratch u decoder, non-systematic "
          "Polar(1024, 512), interp systematic decoder, hybrid kl9 scratch "
          "and interp "
          f"and the block-interp front step at Polar({n}, {k})): BER "
          f"{[round(p.ber, 5) for p in points]} in {wall:.1f} s; launches "
          f"{ {name: launched[name] for name in new} }; plain calls {plain}")

    # -- make_step's default path at plain Polar(32768, 16384), B = 4096 ----
    mid = pt.make_code(MID_PATH_M, rate=0.5)
    path = pt.ber._step_path(mid, torch.int8, None, None, "auto", dev, False,
                             b)
    dec_mid = pt.ber._default_decoder(mid, False, torch.int8, None, dev)
    step = pt.make_step(mid, systematic=False, device=dev)
    g = torch.Generator()
    g.manual_seed(MID_PATH_M)
    _reset(*counts, *plains)
    mid_steps = 2
    outs = [step(g, -1.0, b) for _ in range(mid_steps)]
    torch.cuda.synchronize()
    mid_launched = {name: v for c in counts for name, v in c.items() if v}
    plain = {name: v for c in plains for name, v in c.items()}
    mid_interp = interp_kernel.launches["interp_decoder_frames"]
    if path != "draws" or mid_interp != mid_steps or max(plain.values()):
        raise AssertionError(f"default path at Polar({mid.N}, {mid.K}) B={b}: "
                             f"{path}, launches {mid_launched}, plain {plain}")
    fer = [int(o["frame_errors"]) for o in outs]
    phase("14", f"make_step's default path at plain Polar({mid.N}, {mid.K}) "
          f"B={b} ({path} around {auto.decoder_names(MID_PATH_M, False)}"
          f"): {mid_steps} steps at -1.0 dB, frame errors {fer}; "
          f"interp_decoder_frames {mid_interp} launches "
          f"({mid_interp / mid_steps:g} "
          f"a step); all launches {mid_launched}")
    seen = {}

    def capture(llrs):
        seen["llrs"] = llrs
        return dec_mid(llrs)

    pt.ber.make_step_body(mid, systematic=False, decoder=capture,
                          rng="kernel", device=dev)(g, -1.0, b)
    got = dec_mid(seen["llrs"])
    check("interp_decoder", got,
          pt.make_fastssc_decoder(mid, output_dtype=torch.int8)(seen["llrs"]),
          f"Polar({mid.N}, {mid.K}) default decoder against plain")
    phase("14", f"its decoder on one step's LLRs ({b} frames) == the plain "
          "decoder on the card (max abs err 0)")

    # -- timings at the shapes of the path ----------------------------------
    times, work, by_shape = {}, {}, {}

    def scratch_times(name, where, fn, plain_fn, reps, work_s, launches,
                      steps):
        """The tile kernel by CUDA events (each output dropped) and by the
        profiler's device time, the plain version; a by_shape entry."""
        t, t_p = ms_dropped(fn, reps), ms(plain_fn, 2)
        phase("14", f"{name} at {where}: tile kernel {t:.4f} ms; device "
              f"time {profiled_ms(fn, reps)}; plain {t_p:.3f} ms ({card})")
        by_shape.setdefault(name, {})[where] = {
            "ms": t, "plain_ms": t_p, "work": work_s, "launches": launches,
            "steps": steps}
        return t, t_p

    llr_s = rand_i8(code.N, BATCH)
    times["scratch_decoder"] = scratch_times(
        "scratch_decoder", f"Polar(1024, 512) B={BATCH} u",
        lambda: decoder_kernel.decode(program, code.frozen, llr_s, False,
                                      "scratch"),
        lambda: decoder_kernel.decode_plain(program, code.frozen, llr_s,
                                            False), 20,
        row_work("scratch_decoder", n=code.N, k=code.K, b=BATCH),
        lanes_launched, 1 if lanes_launched else None)
    # the default path of make_auto_decoder's u track (decode/auto.py):
    # the scratch kernel at m = 6, and at m = 7 from BIG_BATCH; one decode
    # through it a shape, counts reset just before
    for m_s, b_s in ((6, 4096), (6, BATCH), (7, BATCH)):
        sc = pt.make_code(m_s, rate=0.5)
        sp = pt.compile_program(sc)
        x = edge_i8(sc.N, b_s)
        dec_s, desc = pt.make_auto_decoder(sc, device=dev)
        _reset(decoder_kernel.launches)
        got = dec_s.lane_major(x)
        n_s = decoder_kernel.launches["scratch_decoder"]
        check("scratch_decoder", got,
              decoder_kernel.decode_plain(sp, sc.frozen, x, False)[0],
              f"auto decoder Polar({sc.N}, {sc.K}) B={b_s}")
        if n_s != 1:
            raise AssertionError(f"auto decoder {desc} at Polar({sc.N}, "
                                 f"{sc.K}) B={b_s}: {decoder_kernel.launches}")
        scratch_times(
            "scratch_decoder", f"Polar({sc.N}, {sc.K}) B={b_s} u (auto)",
            lambda: decoder_kernel.decode(sp, sc.frozen, x, False, "scratch"),
            lambda: decoder_kernel.decode_plain(sp, sc.frozen, x, False), 50,
            row_work("scratch_decoder", n=sc.N, k=sc.K, b=b_s), n_s, None)
    t_ssa = ms(lambda: decoder_kernel.decode(program, code.frozen, llr_s,
                                             False), 20)
    def interp_times(name, where, fn, plain_fn, reps):
        """Rows 13-15: the tile kernel by CUDA events (each output dropped)
        and by the profiler's device time, the plain version."""
        t, t_p = ms_dropped(fn, reps), ms(plain_fn, 1)
        phase("14", f"{name} at {where}: tile kernel {t:.4f} ms; device "
              f"time {profiled_ms(fn, reps)}; plain {t_p:.3f} ms ({card})")
        times[name] = (t, t_p)

    dec = make_interp_decoder(code)
    interp_times("interp_decoder", f"Polar(1024, 512) B={BATCH} u, sl10",
                 lambda: dec.lane_major(llr_s), lambda: dec.plain(llr_s), 10)
    for name in ("scratch_decoder", "interp_decoder"):
        work[name] = row_work(name, n=code.N, k=code.K, b=BATCH)
    node = max(nodes.values(), key=lambda nd: nd.mesg_bits)
    ln = 1 << node.level
    sc = subtree_kernel.make_subtree_decoder(node, style="scratch")
    for bt in (b, 16384):
        slot = rand_i8(ln, bt)
        t = scratch_times(
            "scratch_subtree", f"level-{node.level} node B={bt}",
            lambda: sc(slot),
            lambda: subtree_kernel.decode_plain(node, (slot,)), 20,
            row_work("scratch_subtree", n=ln, b=bt, mesg_bits=node.mesg_bits),
            launched["scratch_subtree"] if bt == b else 0, None)
        if bt == b:
            times["scratch_subtree"] = t
    llr_mid = rand_i8(mid.N, b)
    hyb = pt.make_fastssc_decoder(mid, output_dtype=torch.int8,
                                  kernel_level=kl, kernel_style="scratch")
    phase("14", f"u Polar({mid.N}, {mid.K}) hybrid kl{kl} scratch decode at "
          f"B={b}: {ms_dropped(lambda: hyb.lane_major(llr_mid), 3):.3f} ms; "
          f"device time {profiled_ms(lambda: hyb.lane_major(llr_mid), 3)} "
          f"({card})")
    slot = rand_i8(ln, b)
    it = make_interp_subtree(node, emit_u=False, emit_cw=True)
    interp_times("interp_subtree", f"level-{node.level} node B={b} cw",
                 lambda: it(slot), lambda: it.plain(slot), 10)
    work["scratch_subtree"] = row_work("scratch_subtree", n=ln, b=b,
                                       mesg_bits=node.mesg_bits)
    work["interp_subtree"] = row_work("interp_subtree", n=ln, b=b)
    interp_times("interp_decode_count", f"Polar({n}, {k}) B={b}, sl10",
                 lambda: count(llr_f, cw_f), lambda: count.plain(llr_f, cw_f),
                 2)
    work["interp_decode_count"] = row_work("interp_decode_count", n=n, b=b)
    phase("14", f"SSA whole-code u at Polar(1024, 512) B={BATCH}: {t_ssa:.3f} "
          f"ms ({card})")
    chains = {br: pt.ber.make_front_chain(big, branch=br)
              for br in ("block-interp", "block-hybrid")}
    rates = {br: [] for br in chains}
    for br in list(chains) + list(chains)[::-1]:
        t = ms(lambda: chains[br](params, seeds=(3, 4), call=0, batch=b,
                                  device=dev), 1)
        rates[br].append(round(b / t * 1e3, 1))
    phase("14", f"front step at Polar({n}, {k}) B={b}, frames/s (order "
          f"interp, hybrid, hybrid, interp): block-interp "
          f"{rates['block-interp']}, block-hybrid {rates['block-hybrid']} "
          f"({card})")
    return {"err": err, "times": times, "work": work, "by_shape": by_shape,
            "launched": {name: launched[name] for name in new}}


def frame_entry_phases(dev, card, ms) -> dict:
    """Phase 17: the tile kernels' frame-major u track, the main path of
    rows 1 and 3 (the u entry of the kernel and auto decoders hands the
    kernel (B, N) LLRs). The auto decoder's frame-major entry at
    Polar(1024, 512), B = 4096 (the tile kernel) and BATCH (the scratch
    kernel at the (2, 2) shape): equal bit for bit to the plain version and
    to the transposing entry around the same element-major kernels
    (``fastssc.frame_major``), one frame-major launch a call and no
    element-major one, then timed in turns with the transposing entry by
    CUDA events (new, old, old, new). Then rows 1 and 3's frame-major
    launches at both batches, and each scratch tile shape at the largest
    level up to 10 where it fits, at both batches: against the plain
    version, then in turns with the element-major launch on the transposed
    LLRs, device time a call with the host's hidden (``queued_seconds``).
    Each is a by_shape entry with its bound; rows 1 and 3 take their ms,
    plain ms and error from their frame-major launch at BATCH."""
    import numpy as np
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.decode.fastssc import frame_major
    from polar_tpu_torch.ops.cuda import decoder_kernel, tile_stages
    from polar_tpu_torch.utils.benchmark import queued_seconds
    from polar_tpu_torch.utils.cost import row_work

    code = pt.make_code(10, rate=0.5)
    program = pt.compile_program(code)
    n, k = code.N, code.K
    dec, desc = pt.make_auto_decoder(code, device=dev)
    old = frame_major(dec.lane_major, "transposing entry")
    rng = np.random.default_rng(17)
    err = {"fastssc_decoder_u": 0, "scratch_decoder": 0}
    times, by_shape, entry = {}, {}, {}

    def rand_frames(b, n):
        return torch.from_numpy(
            rng.integers(-128, 128, (b, n)).astype(np.int8)).to(dev)

    def plain_u(prog, frozen, llrs):
        """The plain version's u of frame-major LLRs, (B, K)."""
        return decoder_kernel.decode_plain(prog, frozen, llrs.t().contiguous(),
                                           False)[0].t()

    def check(name, got, want, what):
        e = int((got.int() - want.int()).abs().max())
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} frame-major != plain: {what}")

    keys = ("fastssc_decoder_u", "scratch_decoder", "fastssc_decoder_u_frames",
            "scratch_decoder_frames")
    for b, key in ((4096, "fastssc_decoder_u_frames"),
                   (BATCH, "scratch_decoder_frames")):
        llrs = rand_frames(b, n)
        before = {x: decoder_kernel.launches[x] for x in keys}
        got = dec(llrs)
        moved = {x: decoder_kernel.launches[x] - before[x] for x in keys}
        if moved != {x: int(x == key) for x in keys}:
            raise AssertionError(f"frame-major entry at B={b} launched "
                                 f"{moved}")
        entry[b] = key.removesuffix("_frames")
        style = "ssa" if key.startswith("fastssc") else "scratch"
        check(entry[b], got, plain_u(program, code.frozen, llrs),
              f"auto decoder Polar({n}, {k}) B={b}")
        if not torch.equal(got, old(llrs)):
            raise AssertionError(f"frame-major entry != transposing entry at "
                                 f"Polar({n}, {k}) B={b}")
        t = in_turns(lambda: dec(llrs), lambda: old(llrs), 20)
        phase("17", f"u Polar({n}, {k}) B={b} ({desc}): frame-major entry "
              f"{t['ms']:.4f} ms, transposing entry {t['earlier_ms']:.4f} ms "
              f"({t['earlier_ms'] / t['ms']:.2f}x; {t['turns']}); "
              f"{b / t['ms'] * 1e3:.4g} against "
              f"{b / t['earlier_ms'] * 1e3:.4g} frames/s; "
              f"{stages(decoder_kernel.plan(program, b, style))} ({card})")

    def turns(name, c, prog, llrs, style, shape, launched, what):
        """The frame-major launch against plain, then in turns with the
        element-major one (frame, element, element, frame); a by_shape
        entry, which it returns."""
        b = llrs.shape[0]
        llr_t = llrs.t().contiguous()
        run = (prog, c.frozen)
        frames = lambda: decoder_kernel.decode(  # noqa: E731
            *run, llrs, False, style, shape, layout="frames")
        lanes = lambda: decoder_kernel.decode(  # noqa: E731
            *run, llr_t, False, style, shape)
        where = f"Polar({c.N}, {c.K}) B={b} u, {what}"
        check(name, frames()[0], plain_u(*run, llrs), where)
        f = [queued_seconds(frames, 20)]
        e = [queued_seconds(lanes, 20), queued_seconds(lanes, 20)]
        f.append(queued_seconds(frames, 20))
        t_p = ms(lambda: plain_u(*run, llrs), 2)
        counts = (decoder_kernel.plan(prog, b, style) if shape is None else
                  tile_stages.program_stages(
                      prog, tile_stages.block_rows(*shape[:2]), False,
                      folds=False))
        phase("17", f"{name} at {where}, device ms a call: frame-major "
              f"{f[0] * 1e3:.4f}, {f[1] * 1e3:.4f}; element-major "
              f"{e[0] * 1e3:.4f}, {e[1] * 1e3:.4f}; plain {t_p:.3f} ms; "
              f"{stages(counts)} ({card})")
        by_shape.setdefault(name, {})[where] = row = {
            "ms": sum(f) / 2 * 1e3, "lanes_ms": sum(e) / 2 * 1e3,
            "plain_ms": t_p, "work": row_work(name, n=c.N, k=c.K, b=b),
            "launches": launched, "steps": None}
        return row

    for name, style in (("fastssc_decoder_u", "ssa"),
                        ("scratch_decoder", "scratch")):
        for b in (4096, BATCH):
            t = turns(name, code, program, rand_frames(b, n), style, None,
                      int(entry[b] == name), "frame-major")
        times[name] = (t["ms"], t["plain_ms"])
    for wr, vw in decoder_kernel.SCRATCH_SHAPES:
        level = max(m for m in range(1, 11)
                    if decoder_kernel.scratch_smem(1 << m, wr, 1)
                    <= decoder_kernel.SCRATCH_SMEM_BYTES)
        c = pt.make_code(level, rate=0.5)
        prog = pt.compile_program(c)
        for b in (4096, BATCH):
            table = decoder_kernel.scratch_shape(level, b)
            warps = table[2] if table[:2] == (wr, vw) else 1
            turns("scratch_decoder", c, prog, rand_frames(b, c.N), "scratch",
                  (wr, vw, warps), 0, f"({wr}, {vw}) x{warps} frame-major")
    return {"err": err, "times": times, "work": {}, "launched": {},
            "by_shape": by_shape}


def interp_frames_phases(dev, card, ms) -> dict:
    """Phase 19: the interpreter's frame-major u track, the main path of
    row 13 (the u entry of the interpreter decoder, which
    ``AUTO_DECODERS`` picks for u at m = 13..17, hands the kernel (B, N)
    LLRs and takes (B, K) back). At m = 14, B = 64, 256, 2048, 4096 and
    16384, and at m = 13 and 17 a small and a larger batch, subtree level
    ``INTERP_SUBTREE_LEVEL``: the entry's u equal bit for
    bit to the plain version and to the element-major launch, one
    frame-major launch a call and nothing else; then timed in turns by
    CUDA events (frame-major, element-major on the transposed LLRs, the
    transposing entry around it; then the other way round), and the blocks
    an SM of both instantiations at the launch's region and warps. Each is
    a by_shape entry of row 13 with its bound."""
    import ctypes

    import numpy as np
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.decode.auto import INTERP_SUBTREE_LEVEL
    from polar_tpu_torch.decode.fastssc import frame_major
    from polar_tpu_torch.ops.cuda import build, interp_kernel
    from polar_tpu_torch.utils.cost import row_work

    rng = np.random.default_rng(19)
    by_shape = {}
    shapes = ((14, 64), (14, 256), (14, 2048), (14, 4096), (14, 16384),
              (13, 256), (13, 4096), (17, 64), (17, 1024))
    for m, b in shapes:
        code = pt.make_code(m, rate=0.5)
        n, k = code.N, code.K
        dec = interp_kernel.make_interp_decoder(
            code, subtree_level=INTERP_SUBTREE_LEVEL)
        old = frame_major(dec.lane_major, "transposing entry")
        llrs = torch.from_numpy(
            rng.integers(-128, 128, (b, n)).astype(np.int8)).to(dev)
        llrs[:, ::7] = 0
        llr_t = llrs.t().contiguous()
        before = dict(interp_kernel.launches)
        got = dec(llrs)
        moved = {x: interp_kernel.launches[x] - before[x] for x in before
                 if interp_kernel.launches[x] != before[x]}
        if moved != {"interp_decoder_frames": 1}:
            raise AssertionError(f"frame-major u entry at B={b} launched "
                                 f"{moved}")
        t_p0 = time.perf_counter()
        want = dec.plain(llr_t).t()
        t_p = (time.perf_counter() - t_p0) * 1e3
        if not (torch.equal(got, want) and torch.equal(got, old(llrs))):
            raise AssertionError(f"interp frame-major u != plain at "
                                 f"Polar({n}, {k}) B={b}")
        frames = lambda: dec(llrs)  # noqa: E731
        lanes = lambda: dec.lane_major(llr_t)  # noqa: E731
        entry = lambda: old(llrs)  # noqa: E731
        t = {"frames": [], "lanes": [], "entry": []}
        for name in ("frames", "lanes", "entry", "entry", "lanes", "frames"):
            t[name].append(ms_dropped({"frames": frames, "lanes": lanes,
                                       "entry": entry}[name], 20))
        plan = dec.plan(b, dev)
        per_sm = {}
        for layout in (0, 1):
            got_sm = ctypes.c_int(0)
            build.check(build.load_library().polar_interp_tile_occupancy(
                0, 1, layout, dec.compiled.sched.region_level, plan["warps"],
                ctypes.byref(got_sm)), "polar_interp_tile_occupancy")
            per_sm["frames" if layout else "lanes"] = got_sm.value
        where = f"Polar({n}, {k}) B={b} u, sl{INTERP_SUBTREE_LEVEL}"
        phase("19", f"interp_decoder at {where}, ms a call: frame-major "
              f"{t['frames'][0]:.4f}, {t['frames'][1]:.4f}; element-major "
              f"{t['lanes'][0]:.4f}, {t['lanes'][1]:.4f}; transposing entry "
              f"{t['entry'][0]:.4f}, {t['entry'][1]:.4f}; == plain "
              f"({t_p:.0f} ms); blocks an SM {per_sm} at {plan['warps']} "
              f"warps, grid {plan['blocks']}; {stages(plan)} ({card})")
        by_shape[where] = {
            "ms": sum(t["frames"]) / 2, "lanes_ms": sum(t["lanes"]) / 2,
            "earlier_ms": sum(t["entry"]) / 2, "plain_ms": t_p,
            "work": row_work("interp_decoder", n=n, k=k, b=b),
            "launches": 0, "steps": None}
    return {"err": {"interp_decoder": 0}, "times": {}, "work": {},
            "launched": {}, "by_shape": {"interp_decoder": by_shape}}


def frame_count_inputs(gen, batch: int, k: int, n: int, dev):
    """(message, codeword, llrs, decoded) frame-major int8 for the u
    counter: ±1 message and codeword, full-range LLRs, estimates equal to
    the message but for about 1 % zeros and 1 % flipped signs."""
    import torch

    def rand_i8(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    msg = 1 - 2 * rand_i8((batch, k), 0, 2)
    cw = 1 - 2 * rand_i8((batch, n), 0, 2)
    dec = msg.clone()
    dec[rand_i8((batch, k), 0, 100) == 0] = 0
    dec[rand_i8((batch, k), 0, 100) == 0] *= -1
    return msg, cw, rand_i8((batch, n), -128, 128), dec


def count_frames_phases(dev, card, ms) -> dict:
    """Phase 18: the draws path's u-domain counter (``count_frames_kernel``,
    which replaces no Pallas kernel: the JAX package's draws-path counters
    are jnp). At Polar(16384, 8192), B = 4096 and Polar(1024, 512),
    B = 32768: the kernel against its plain version (the torch expressions
    of ``ber.frame_counters``) on the 16-byte path and, at a one-byte
    offset, the byte path, max abs err 0, one launch a call; then timed in
    turns with the plain version (kernel, plain, plain, kernel), device
    time a call with the host's hidden (``queued_seconds``: at 0.04 ms a
    call the wrapper's host time would set the pace), beside its bound.
    Then its main path: a non-systematic Polar(16384, 8192) campaign on
    the draws path, counts reset just before: one launch a step, no plain
    call."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import count_kernel
    from polar_tpu_torch.utils.benchmark import queued_seconds
    from polar_tpu_torch.utils.cost import bound, row_work

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    err, by_shape = 0, {}

    def moved(t):
        buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=dev)
        x = buf[1:].view(t.shape)
        x.copy_(t)
        return x

    for m, b in ((14, 4096), (10, BATCH)):
        code = pt.make_code(m, rate=0.5)
        n, k = code.N, code.K
        args = frame_count_inputs(gen, b, k, n, dev)
        want = count_kernel.count_frames_plain(*args)
        for label, t in (("16-byte", args),
                         ("byte", tuple(moved(x) for x in args))):
            before = count_kernel.launches["count_frames"]
            got = count_kernel.count_frames(*t)
            if count_kernel.launches["count_frames"] != before + 1:
                raise AssertionError("count_frames launched "
                                     f"{count_kernel.launches}")
            e = int((got - want).abs().max())
            err = max(err, e)
            if e:
                raise AssertionError(f"count_frames != plain ({label} path) "
                                     f"at Polar({n}, {k}) B={b}: "
                                     f"{got.tolist()} against {want.tolist()}")
        kernel = lambda: count_kernel.count_frames(*args)  # noqa: E731
        plain = lambda: count_kernel.count_frames_plain(*args)  # noqa: E731
        t = [queued_seconds(kernel, 20)]
        p = [queued_seconds(plain, 20), queued_seconds(plain, 20)]
        t.append(queued_seconds(kernel, 20))
        t_ms, p_ms = sum(t) / 2 * 1e3, sum(p) / 2 * 1e3
        work = row_work("count_frames", n=n, k=k, b=b)
        b_ms, b_by = bound(*work)
        where = f"Polar({n}, {k}) B={b}"
        phase("18", f"count_frames == plain (16-byte and byte paths, max abs "
              f"err 0) at {where}: {want.tolist()}; device ms a call, host "
              f"hidden: kernel {t[0] * 1e3:.4f}, {t[1] * 1e3:.4f}; plain "
              f"{p[0] * 1e3:.4f}, {p[1] * 1e3:.4f}; bound {b_ms:.4f} ms "
              f"({b_by}), {t_ms / b_ms:.2f}x the bound ({card})")
        by_shape[where] = {"ms": t_ms, "plain_ms": p_ms, "work": work,
                           "launches": 0, "steps": None}

    code = pt.make_code(14, rate=0.5)
    b = 4096
    _reset(count_kernel.launches, count_kernel.plain_calls)
    res = pt.run_campaign(code, systematic=False, device=dev, seed=18,
                          batch=b, steps_per_call=2, snr_range=(-1.5, -1.5),
                          max_frames_per_point=2 * b,
                          measure_throughput=False)
    steps = sum(p.frames for p in res.points) // b
    if (count_kernel.launches["count_frames"] != steps or steps == 0
            or max(count_kernel.plain_calls.values())):
        raise AssertionError(f"draws-path campaign: {steps} steps, launches "
                             f"{count_kernel.launches}, plain calls "
                             f"{count_kernel.plain_calls}")
    where = f"Polar({code.N}, {code.K}) B={b}"
    by_shape[where].update(launches=steps, steps=steps)
    phase("18", f"non-systematic campaign at {where} on the draws path: "
          f"{steps} steps, count_frames launches {steps}, no plain call; "
          f"FER {res.points[0].fer:.4g}")
    first = by_shape[where]
    return {"err": {"count_frames": err},
            "times": {"count_frames": (first["ms"], first["plain_ms"])},
            "work": {"count_frames": first["work"]},
            "launched": {"count_frames": steps},
            "by_shape": {"count_frames": by_shape}}


def f32_decode_phases(dev, card, ms) -> dict:
    """Phase 20: the float32 u track (``decoder_kernel.decode_f32``, which
    replaces no Pallas kernel: the JAX package's float path is eager jnp).
    At Polar(1024, 512), B = BATCH, float32 LLRs of the -1.0 dB channel
    with ±0, exact-zero sums and tied minima planted in some frames: the
    kernel against its plain version (the eager float decoder on the
    card), max abs err 0, one launch a call, then through
    ``make_auto_decoder``'s u entry (one launch a call, its main path);
    timed by CUDA events in turns with the eager float decoder (kernel,
    eager, eager, kernel), beside its bound."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.ops.cuda import decoder_kernel
    from polar_tpu_torch.utils.cost import bound, row_work

    code = pt.make_code(10, rate=0.5)
    n, k, b = code.N, code.K, BATCH
    program = pt.compile_program(code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    sigma, scale = snr_params(-1.0)
    cw = 1 - 2 * torch.randint(0, 2, (b, n), generator=gen, device=dev)
    llrs = scale * (cw + sigma * torch.randn((b, n), generator=gen,
                                             device=dev))
    llrs[0] = -0.0
    llrs[1] = 0.0
    llrs[2:64] = torch.randint(-2, 3, (62, n), generator=gen,
                               device=dev).float()
    llrs[64:128] = (torch.randint(1, 4, (64, n), generator=gen, device=dev)
                    * (1 - 2 * torch.randint(0, 2, (64, n), generator=gen,
                                             device=dev))).float() / 2
    llrs = llrs.contiguous()
    eager = pt.make_fastssc_decoder(code, output="u", output_dtype=torch.int8)
    want = eager(llrs)
    _reset(decoder_kernel.launches, decoder_kernel.plain_calls)
    got = decoder_kernel.decode_f32(program, code.frozen, llrs)
    direct = dict(decoder_kernel.launches)
    dec, _ = pt.make_auto_decoder(code, output="u", device=dev)
    _reset(decoder_kernel.launches)
    auto = dec(llrs)
    main = dict(decoder_kernel.launches)
    launched = main["f32_decoder_frames"]
    err = max(int((x.int() - want.int()).abs().max()) for x in (got, auto))
    if (err or direct["f32_decoder_frames"] != 1 or launched != 1
            or sum(main.values()) != 1
            or max(decoder_kernel.plain_calls.values())):
        raise AssertionError(f"f32 decoder: max abs err {err}, launches "
                             f"direct {direct}, main path {main}, plain "
                             f"calls {decoder_kernel.plain_calls}")
    kernel = lambda: decoder_kernel.decode_f32(program, code.frozen, llrs)  # noqa: E731
    t = [ms(kernel, 20)]
    e = [ms(lambda: eager(llrs), 3), ms(lambda: eager(llrs), 3)]
    t.append(ms(kernel, 20))
    t_ms, e_ms = sum(t) / 2, sum(e) / 2
    work = row_work("f32_decoder", n=n, k=k, b=b)
    b_ms, b_by = bound(*work)
    phase("20", f"f32 decoder == eager float decoder (max abs err 0, "
          f"{int((want == 0).sum())} zero bits) at Polar({n}, {k}) B={b} "
          f"float32; auto decoder: one launch a call; ms a call: kernel "
          f"{t[0]:.4f}, {t[1]:.4f}; eager {e[0]:.3f}, {e[1]:.3f} "
          f"({e_ms / t_ms:.1f}x); bound {b_ms:.4f} ms ({b_by}), "
          f"{t_ms / b_ms:.1f}x the bound; "
          f"{stages(decoder_kernel.plan(program, b, f32=True))} ({card})")
    return {"err": {"f32_decoder": err},
            "times": {"f32_decoder": (t_ms, e_ms)},
            "work": {"f32_decoder": work},
            "launched": {"f32_decoder": launched}}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multihost_pair(m: int, checkpoint: Path, device: str = "cuda:0") -> list:
    """The multihost CLI as two processes over gloo, both on ``device``
    with two mesh positions each; returns each process's points (its last
    stdout line). One retry on a fresh port: the port found free may be
    taken before the lead binds it."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for attempt in range(2):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "polar_tpu_torch.parallel.multihost",
             "--m", str(m), "--per-device-batch", "4096",
             "--max-global-frames", "65536", "--target-errors", "1000",
             "--snr-min", "-0.4", "--snr-max", "0.0", "--snr-step", "0.2",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(r), "--device", device, "--positions",
             "2", "--checkpoint", str(checkpoint)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        outs = []
        for proc in procs:
            try:
                out, errs = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for other in procs:
                    other.kill()
                    other.communicate()
                raise
            outs.append((proc.returncode, out, errs))
        if all(rc == 0 for rc, _, _ in outs):
            return [json.loads(out.strip().splitlines()[-1])["points"]
                    for _, out, _ in outs]
        if attempt:
            raise AssertionError("multihost pair failed twice: " + " | ".join(
                f"rc={rc} {errs[-1500:]}" for rc, _, errs in outs))


def parallel_phases(dev, card, ms) -> dict:
    """Phase 15: the parallel layer, driven from one process over a mesh of
    8 positions on one card. The ring-shift kernel against its plain
    version (2, 4, 8 positions; offsets +-1, +-2, 4; int8 (16384, 4096),
    stacked (2, 16384, 4096), (1, 4096), f32 (512, 64)); the sharded
    encoder at m = 17; the element-sharded decoder at Polar(131072, 65536),
    S = 16384, B = 4096, against the local auto decoder over both
    transports, with and without batch_split, both outputs, its rdma run
    the slice's main path (counts reset just before); the frame-sharded
    step at Polar(1024, 512) against the unsharded steps and a sharded
    point against results/n1024_sys_int8.json; dryrun_multichip(8); the
    multihost CLI as two processes on the card, then resumed from its
    checkpoint; timings."""
    import numpy as np
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import (channel_kernel, count_kernel,
                                          decoder_kernel, encode_kernel,
                                          front_kernel, interp_kernel,
                                          ring_kernel, step_kernel,
                                          subtree_kernel)
    from polar_tpu_torch.parallel.campaign import (device_seeds,
                                                   make_sharded_step,
                                                   run_sharded_point)
    from polar_tpu_torch.parallel.dryrun import dryrun_multichip
    from polar_tpu_torch.parallel.mesh import frame_mesh
    from polar_tpu_torch.parallel.seqpar import (element_mesh,
                                                 make_sharded_encoder)
    from polar_tpu_torch.parallel.seqpar_decode import make_seqpar_decoder
    from polar_tpu_torch.utils.cost import row_work

    err = {"ring_shift": 0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    code = pt.make_code(LARGE_M, rate=0.5)
    n, k, b = code.N, code.K, LARGE_BATCH
    shard = n // PAR_SHARDS

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # -- the ring-shift kernel against its plain version --------------------
    payloads = {
        f"int8 ({shard}, {b})": lambda: rand_i8(shard, b),
        f"stacked (2, {shard}, {b})": lambda: rand_i8(2, shard, b),
        f"(1, {b})": lambda: rand_i8(1, b),
        "f32 (512, 64)": lambda: torch.randn((512, 64), generator=gen,
                                             device=dev),
    }
    offsets = (1, -1, 2, -2, 4)
    for n_pos in (2, 4, PAR_SHARDS):
        for name, make in payloads.items():
            blocks = [make() for _ in range(n_pos)]
            for off in offsets:
                got = ring_kernel.ring_shift(blocks, off)
                want = ring_kernel.ring_shift_plain(blocks, off)
                e = max(float((g.double() - w.double()).abs().max())
                        for g, w in zip(got, want))
                err["ring_shift"] = max(err["ring_shift"], e)
                if e or not all(torch.equal(g, blocks[(d + off) % n_pos])
                                for d, g in enumerate(got)):
                    raise AssertionError(f"ring shift differs: {n_pos} "
                                         f"positions, {name}, offset {off}")
                del got, want
            del blocks
    phase("15", f"ring-shift kernel == plain == the shifted blocks at 2, 4, "
          f"{PAR_SHARDS} positions, offsets {list(offsets)}, payloads "
          f"{list(payloads)} (max abs err 0)")

    # -- the sharded encoder -------------------------------------------------
    mesh = element_mesh([dev] * PAR_SHARDS)
    msg = (1 - 2 * torch.randint(0, 2, (64, k), generator=gen, device=dev)
           ).to(torch.int8)
    for systematic, enc in ((True, pt.encode_systematic), (False, pt.encode)):
        got = make_sharded_encoder(code, mesh, systematic=systematic)(msg)
        if not torch.equal(got, enc(code, msg)):
            raise AssertionError(f"sharded encoder differs, "
                                 f"systematic={systematic}")
    phase("15", f"sharded encoder (systematic and plain) == local at "
          f"Polar({n}, {k}) over {PAR_SHARDS} positions, B=64")

    # -- the main path: the element-sharded decode over the ring kernel ----
    llr_t = rand_i8(n, b)
    assert bool((llr_t == -128).any()) and bool((llr_t == 0).any())
    local = pt.make_auto_decoder(code, output="u", device=dev)[0].lane_major
    want = local(llr_t)
    counts = (decoder_kernel.launches, subtree_kernel.launches,
              interp_kernel.launches, step_kernel.launches,
              front_kernel.launches, count_kernel.launches,
              channel_kernel.launches, encode_kernel.launches,
              ring_kernel.launches)
    plains = (decoder_kernel.plain_calls, subtree_kernel.plain_calls,
              interp_kernel.plain_calls, step_kernel.plain_calls,
              front_kernel.plain_calls, count_kernel.plain_calls,
              channel_kernel.plain_calls, encode_kernel.plain_calls,
              ring_kernel.plain_calls)
    llrs = llr_t.t().contiguous()
    decode = make_seqpar_decoder(code, mesh, output="u", comm="rdma")
    _reset(*counts, *plains)
    t0 = time.perf_counter()
    got = decode(llrs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {name: v for c in counts for name, v in c.items()}
    plain = {name: v for c in plains for name, v in c.items()}
    if (launched["ring_shift"] == 0 or launched["subtree_decoder"] == 0
            or max(plain.values()) != 0):
        raise AssertionError(f"sharded decode launches {launched}, plain "
                             f"calls {plain}")
    if not torch.equal(got.t(), want):
        raise AssertionError("rdma sharded decode differs from the local "
                             "decoder")
    del llrs, got
    phase("15", f"main path: rdma sharded decode (frame-major entry) == local "
          f"auto decoder at Polar({n}, {k}) over {PAR_SHARDS} positions on "
          f"one card, B={b}, in {wall:.2f} s; launches "
          f"{ {name: v for name, v in launched.items() if v} }; plain calls "
          f"{plain}")

    frozen = torch.as_tensor(code.frozen.astype(bool), device=dev)
    info = torch.as_tensor(code.info_indices, device=dev)
    decoders = {}
    for comm in ("ppermute", "rdma"):
        for split in (False, True):
            for output in ("u", "u_full"):
                dec = make_seqpar_decoder(code, mesh, output=output,
                                          comm=comm, batch_split=split)
                out = dec.lane_major(llr_t)
                ok = (torch.equal(out, want) if output == "u" else
                      torch.equal(out[info], want)
                      and bool((out[frozen] == 1).all()))
                if not ok:
                    raise AssertionError(f"sharded decode differs: comm="
                                         f"{comm} batch_split={split} "
                                         f"output={output}")
                del out
                if output == "u":
                    decoders[(comm, split)] = dec
    phase("15", "sharded decode == local auto decoder bit for bit: comm "
          "ppermute/rdma x batch_split off/on x output u/u_full (frozen "
          "slots +1)")

    # -- the frame-sharded step and a sharded point ----------------------
    c10 = pt.make_code(10, rate=0.5)
    fmesh = frame_mesh([dev] * PAR_SHARDS)
    step, _ = make_sharded_step(c10, fmesh)
    sharded = {key: int(v) for key, v in
               step(device_seeds(15, fmesh), -1.0, 4096).items()}
    body = pt.make_step(c10, device=dev)
    alone = dict.fromkeys(sharded, 0)
    for g in device_seeds(15, fmesh):
        for key, v in body(g, -1.0, 4096).items():
            alone[key] += int(v)
    if sharded != alone or sharded["uncorrected_errors"] == 0:
        raise AssertionError(f"sharded step {sharded} != unsharded {alone}")
    phase("15", f"frame-sharded step at Polar(1024, 512), {PAR_SHARDS} "
          f"positions x 4096 frames, -1.0 dB: {sharded} == the sum of the "
          "unsharded steps")
    ref = {round(p["snr_db"], 1): p for p in json.loads(
        (ROOT / "results" / "n1024_sys_int8.json").read_text())["points"]}[0.0]
    tot = run_sharded_point(c10, 0.0, seed=15, mesh=fmesh,
                            per_device_batch=4096, max_global_frames=1 << 18,
                            target_bit_errors=4000)
    frames = tot["frames"]
    ok_b, sd_b = ber_ok(tot["uncorrected_errors"], frames, ref["bit_errors"],
                        ref["frames"], c10.K)
    ok_f, sd_f = bounds_ok(tot["frame_errors"], frames,
                           ref["fer"] * ref["frames"], ref["frames"])
    ber = tot["uncorrected_errors"] / (frames * c10.K)
    phase("15", f"run_sharded_point at 0.0 dB: BER {ber:.4g} FER "
          f"{tot['frame_errors'] / frames:.4g} ({frames} frames) vs "
          f"n1024_sys_int8.json BER {ref['ber']:.4g} FER {ref['fer']:.4g}, "
          f"{SIGMAS:g}-sigma bounds {SIGMAS * sd_b:.3g} / {SIGMAS * sd_f:.3g}"
          f": {'ok' if ok_b and ok_f else 'OUTSIDE'}")
    if not (ok_b and ok_f):
        raise AssertionError("sharded point outside the bounds")

    # -- the dry run and the multihost CLI -----------------------------------
    dryrun_multichip(PAR_SHARDS, dev)
    phase("15", f"dryrun_multichip({PAR_SHARDS}, {dev}): six checks passed")
    work_dir = ROOT / "build" / "multihost"
    work_dir.mkdir(parents=True, exist_ok=True)
    ckpt = work_dir / "checkpoint.json"
    ckpt.unlink(missing_ok=True)
    t0 = time.perf_counter()
    first = _multihost_pair(10, ckpt)
    t_first = time.perf_counter() - t0
    if first[0] != first[1] or len(first[0]) < 2:
        raise AssertionError(f"multihost processes disagree: {first}")
    t0 = time.perf_counter()
    second = _multihost_pair(10, ckpt)
    t_second = time.perf_counter() - t0
    if second != first:
        raise AssertionError(f"resumed multihost run differs: {second}")
    phase("15", f"multihost CLI, 2 processes x 2 positions on one card over "
          f"gloo, Polar(1024, 512): both print the same "
          f"{len(first[0])} points (BER "
          f"{[round(p['ber'], 6) for p in first[0]]}) in {t_first:.1f} s; "
          f"resumed from the lead's checkpoint: the same points in "
          f"{t_second:.1f} s")

    # -- timings ------------------------------------------------------------
    blocks = [rand_i8(shard, b) for _ in range(PAR_SHARDS)]
    outs = [torch.empty_like(x) for x in blocks]

    def library():
        for d in range(PAR_SHARDS):
            outs[d].copy_(blocks[(d + 1) % PAR_SHARDS])

    def kernel():     # outputs dropped at once, as the decoder drops them
        ring_kernel.ring_shift(blocks, 1)

    def plain_shift():
        ring_kernel.ring_shift_plain(blocks, 1)

    t_k, t_p, t_l = [], [], []
    for _ in range(2):   # in turns: kernel, library, library, kernel, twice
        t_k.append(ms(kernel, 20))
        t_l += [ms(library, 20), ms(library, 20)]
        t_k.append(ms(kernel, 20))
        t_p.append(ms(plain_shift, 20))
    times = {"ring_shift": (min(t_k), min(t_p))}
    phase("15", f"ring shift {PAR_SHARDS} x ({shard}, {b}) int8, in turns: "
          f"kernel {t_k} ms (mean {sum(t_k) / 4:.4f}, spread "
          f"{max(t_k) - min(t_k):.4f}), {PAR_SHARDS} Tensor.copy_ {t_l} ms "
          f"(mean {sum(t_l) / 4:.4f}, spread {max(t_l) - min(t_l):.4f}), "
          f"plain {t_p} ms ({card})")
    del blocks, outs
    t_local = ms(lambda: local(llr_t), 3)
    dec_ms = {key: ms(lambda: d.lane_major(llr_t), 2)
              for key, d in decoders.items()}
    phase("15", f"decode at Polar({n}, {k}) B={b}: local auto {t_local:.1f} "
          "ms; sharded over " + f"{PAR_SHARDS} positions on one card: " +
          ", ".join(f"{comm}{' batch_split' if split else ''} {v:.1f} ms "
                    f"({v / t_local:.2f}x)"
                    for (comm, split), v in dec_ms.items()) + f" ({card})")
    return {"err": err, "times": times,
            "work": {"ring_shift": row_work("ring_shift", n=shard, b=b,
                                            shards=PAR_SHARDS)},
            "launched": {"ring_shift": launched["ring_shift"]},
            "library": {"ring_shift": min(t_l)}}


def module_phases(dev, card, ms) -> dict:
    """Phase 16, the modules the last slice ported and the fused step's
    bits mode: (a) the native construction and compiler, built here,
    against numpy; (b) the code store and the decoder cache on the card;
    (c) the throughput CLI's per-N table at m = 6..16 (the decoders auto
    picks, their launches, no plain call); (d) the curve-set CLI at m = 8
    and 10, both modes, against the JAX package's result files, then
    resumed with no new step; (e) a campaign point traced through
    utils.profiling with an annotation; (f) the bits-mode step against
    native mode on the words native mode draws (the tile step at
    Polar(1024, 512) and m = 2, the walk at m = 13), then in turns with
    native mode. Each part prints its seconds."""
    import tempfile

    import numpy as np
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch import curve_set, throughput
    from polar_tpu_torch.campaign_io import load_result
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.code import construction, native
    from polar_tpu_torch.code.store import DecoderCache
    from polar_tpu_torch.decode import auto
    from polar_tpu_torch.ops.cuda import (channel_kernel, count_kernel,
                                          decoder_kernel, encode_kernel,
                                          front_kernel, interp_kernel,
                                          philox, ring_kernel, step_kernel,
                                          subtree_kernel)
    from polar_tpu_torch.utils.benchmark import measure_decode_fps
    from polar_tpu_torch.utils.cost import bound, row_work
    from polar_tpu_torch.utils.profiling import (annotate, own_kernels,
                                                 trace, trace_events)

    mods = (channel_kernel, count_kernel, decoder_kernel, encode_kernel,
            front_kernel, interp_kernel, ring_kernel, step_kernel,
            subtree_kernel)
    counts = [c for mod in mods for c in (
        mod.launches, getattr(mod, "earlier_launches", {}))]
    plains = [mod.plain_calls for mod in mods]

    def nonzero(dicts):
        return {name: v for d in dicts for name, v in d.items() if v}

    # -- a. native construction and compile --------------------------------
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    native.load()
    t_build = time.perf_counter() - t0
    for m in (10, 16, 20):
        t0 = time.perf_counter()
        a = native.frozen_mask_fixed_k(m, 1 << (m - 1))
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = construction.frozen_mask_fixed_k(m, 1 << (m - 1))
        t_np = time.perf_counter() - t0
        if not np.array_equal(a, b):
            raise AssertionError(f"native fixed-K mask differs at m={m}")
        line = f"m={m}: fixed-K mask C {t_c:.3f} s == numpy {t_np:.3f} s"
        if m <= 16:
            t0 = time.perf_counter()
            prog = native.compile_program(a, m)
            t_c = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = pt.compile_program(pt.PolarCode(m, b))
            t_np = time.perf_counter() - t0
            if not np.array_equal(prog, want):
                raise AssertionError(f"native program differs at m={m}")
            line += f"; program C {t_c:.3f} s == numpy {t_np:.3f} s"
        phase("16a", line)
    phase("16a", f"native extension {native.library_path().name} built and "
          f"loaded in {t_build:.2f} s; part (a) {time.perf_counter() - t_all:.1f} s")

    # -- b. code store and decoder cache -----------------------------------
    t0 = time.perf_counter()
    code = pt.make_code(10, rate=0.5)
    with tempfile.TemporaryDirectory() as tmp:
        pt.save_code(code, Path(tmp) / "code.npz")
        loaded = pt.load_code(Path(tmp) / "code.npz")
    if loaded != code:
        raise AssertionError("load_code(save_code(code)) != code")
    cache = DecoderCache(pt.make_auto_decoder)
    dec, desc = cache.get(code, device=dev)
    if cache.get(loaded, device=dev)[0] is not dec or len(cache) != 1:
        raise AssertionError("the decoder cache built a second decoder")
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    llrs = torch.randint(-128, 128, (4096, code.N), generator=gen,
                         device=dev, dtype=torch.int8)
    _reset(*counts, *plains)
    got = dec(llrs)
    launched = nonzero(counts)
    want = pt.make_fastssc_decoder(code, output_dtype=torch.int8)(llrs)
    if not torch.equal(got, want) or not launched or nonzero(plains):
        raise AssertionError(f"cached decoder ({desc}): launches {launched}, "
                             f"plain calls {nonzero(plains)}, equal "
                             f"{torch.equal(got, want)}")
    phase("16b", f"save_code/load_code round trip at Polar({code.N}, "
          f"{code.K}); DecoderCache(make_auto_decoder) gives one decoder "
          f"({desc}), launches {launched}, == the eager decoder on the "
          f"card; {time.perf_counter() - t0:.1f} s")

    # -- c. the throughput table -------------------------------------------
    t0 = time.perf_counter()
    table = []
    for code, llrs in throughput.inputs(np.random.default_rng(5),
                                        (6, 8, 10, 12, 14, 16), dev):
        dec, desc = pt.make_auto_decoder(code, device=dev)
        _reset(*counts, *plains)
        fps = measure_decode_fps(dec, llrs, iters=64)
        launched, plain = nonzero(counts), nonzero(plains)
        # the decoder auto picks at this batch, and the one it picks for
        # the single frame measure_decode_fps decodes first to learn K
        kernel, probe = ({"scratch": "scratch_decoder_frames",
                          "ssa": "fastssc_decoder_u_frames",
                          "interp": "interp_decoder_frames"}[name]
                         for name in (
            auto.decoder_names(code.level, False)[
                llrs.shape[0] >= auto.BIG_BATCH],
            auto.decoder_names(code.level, False)[0]))
        if (plain or launched.get(kernel, 0) < 2
                or set(launched) - {kernel, probe}
                or (probe != kernel and launched.get(probe) != 1)):
            raise AssertionError(f"throughput at N={code.N}: launches "
                                 f"{launched}, plain calls {plain}")
        row = {"n": code.N, "batch": llrs.shape[0], "decoder": desc,
               "fps": fps, "launches": launched}
        if code.N == 1024:
            row["vs_baseline"] = fps / AVX2_REFERENCE_FPS_N1024
        table.append(row)
        phase("16c", f"N={code.N:6d} B={llrs.shape[0]} [{desc}] "
              f"{fps:14,.0f} frames/s; launches {launched}, plain calls 0"
              + (f"; vs_baseline {row['vs_baseline']:.3f} (AVX2 "
                 f"{AVX2_REFERENCE_FPS_N1024:,.0f} frames/s at Polar(1024, "
                 "512))" if "vs_baseline" in row else "") + f" ({card})")
        del llrs
    phase("16c", "throughput " + json.dumps(table))
    phase("16c", f"part (c) {time.perf_counter() - t0:.1f} s")

    # -- d. the curve set against the JAX package's results ----------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--ms", "8", "10", "--batch", "4096", "--max-frames", "8192",
                "--snr-min", "-1.0", "--snr-max", "0.0", "--outdir", tmp,
                "--plot", "", "--device", str(dev)]
        _reset(*counts, *plains)
        if curve_set.main(argv) != 0:
            raise AssertionError("curve_set failed")
        launched, plain = nonzero(counts), nonzero(plains)
        if not launched or plain:
            raise AssertionError(f"curve set launches {launched}, plain "
                                 f"calls {plain}")
        files = {}
        for m in (8, 10):
            for systematic in (True, False):
                name = curve_set.tag(m, systematic)
                files[name] = (Path(tmp) / f"{name}.json").read_text()
                res = load_result(Path(tmp) / f"{name}.json")
                ref = (f"n{1 << m}_{'sys' if systematic else 'nonsys'}"
                       "_int8.json")
                campaign_vs_reference("16d", res, ref, res.code_k,
                                      len(res.points))
        _reset(*counts, *plains)
        if curve_set.main(argv) != 0:
            raise AssertionError("curve_set failed on resuming")
        again = {name: (Path(tmp) / f"{name}.json").read_text()
                 for name in files}
        if nonzero(counts) or nonzero(plains) or again != files:
            raise AssertionError(f"resumed curve set launched "
                                 f"{nonzero(counts)}, plain calls "
                                 f"{nonzero(plains)}, files changed "
                                 f"{again != files}")
    phase("16d", f"curve set m = 8, 10, both modes: launches {launched}; "
          f"resumed with no launch and the files unchanged; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- e. a campaign point traced, three sessions: the port's kernels in
    # each trace file are a reading (a session at times records none of
    # them, PERF.md section 7); the annotation must be there
    t0 = time.perf_counter()
    code = pt.make_code(10, rate=0.5)
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(3):
            point_gen = torch.Generator()
            point_gen.manual_seed(1)
            _reset(*counts)
            with trace(tmp) as prof:
                with annotate("polar_point"):
                    point = pt.run_point(code, -0.5, gen=point_gen,
                                         batch=BATCH, max_frames=2 * BATCH,
                                         device=dev)
            events = trace_events(prof.trace_file)
            if not any(e.get("name") == "polar_point" for e in events):
                raise AssertionError("the trace lacks the annotation")
            kernels = [e for e in events if e.get("cat") == "kernel"]
            own = own_kernels(prof.trace_file)
            readings.append(f"{len(own)} of {sum(nonzero(counts).values())} "
                            f"launches of the port's kernels, "
                            f"{len(kernels) - len(own)} of torch's")
    phase("16e", f"traced run_point at Polar({code.N}, {code.K}) B={BATCH}, "
          f"-0.5 dB (BER {point.ber:.4g}), three sessions: the annotation in "
          f"each trace file; recorded: {'; '.join(readings)}; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- f. the fused step's bits mode -------------------------------------
    t0 = time.perf_counter()
    by_shape = {}
    for m, b in ((10, BATCH), (2, 4096), (13, 4096)):
        c = pt.make_code(m, rate=0.5)
        seeds, call = (m, 16), 1
        words = philox.to_int32(philox.random_bits(seeds, call, 2 * c.N, b,
                                                   dev))
        kernel = step_kernel.step_kernel_name(c.N)
        for systematic in (True, False):
            args = (pt.compile_program(c), c.frozen, snr_params(-0.5),
                    systematic)
            _reset(step_kernel.launches)
            bits = step_kernel.step(*args, words_t=words)
            nat = step_kernel.step(*args, seeds=seeds, call=call, batch=b,
                                   device=dev)
            name = "mc_step" if kernel == "tile" else "walk_step"
            if (not torch.equal(bits, nat)
                    or step_kernel.launches[name] != 2):
                raise AssertionError(f"bits step {bits.tolist()} vs native "
                                     f"{nat.tolist()} at m={m} "
                                     f"sys={systematic}; launches "
                                     f"{step_kernel.launches}")
            phase("16f", f"bits step == native step ({kernel}) at "
                  f"Polar({c.N}, {c.K}) B={b} sys={systematic}: "
                  f"{bits.tolist()}")
        if (m, b) == (10, BATCH):
            args = (pt.compile_program(c), c.frozen, snr_params(1.0), True)
            t = in_turns(lambda: step_kernel.step(*args, words_t=words),
                         lambda: step_kernel.step(
                             *args, seeds=seeds, call=call, batch=b,
                             device=dev), 20)
            w = row_work("mc_step", n=c.N, k=c.K, b=b, bits=True)
            where = f"Polar({c.N}, {c.K}) B={b} bits"
            by_shape[where] = {
                "ms": t["ms"], "native_ms": t["earlier_ms"],
                "plain_ms": ms(lambda: step_kernel.step_plain(
                    *args, words_t=words), 3),
                "launches": 0, "steps": 0, "work": w}
            turns = t["turns"].replace("new", "bits").replace("old", "native")
            phase("16f", f"mc_step bits mode at {where[:-5]}: {t['ms']:.4f} "
                  f"ms, native mode {t['earlier_ms']:.4f} ms ({turns}); "
                  f"bound {bound(*w)[0]:.4f} ms ({bound(*w)[1]}) ({card})")
        del words
    phase("16f", f"part (f) {time.perf_counter() - t0:.1f} s; phase 16 "
          f"{time.perf_counter() - t_all:.1f} s")
    return {"err": {}, "times": {}, "work": {}, "launched": {},
            "by_shape": {"mc_step": by_shape}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.decode.auto import make_kernel_decoder
    from polar_tpu_torch.ops.cuda import (build, count_kernel, decoder_kernel,
                                          front_kernel, step_kernel,
                                          subtree_kernel, tile_stages)
    from polar_tpu_torch.utils.benchmark import measure_decode_fps
    from polar_tpu_torch.utils.cost import bound, row_work

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

    # -- 2. decoder kernel: packed functions, golden vectors, plain --------
    bad = decoder_kernel.simd_selftest(dev)
    if any(bad.values()):
        raise AssertionError(f"packed functions differ from scalar: {bad}")
    phase("2", f"packed functions == scalar functions on all 65536 int8 "
          f"pairs (madd under h = -1, 0, +1): mismatches {bad}")
    with np.load(ROOT / "tests" / "vectors" / "golden.npz") as z:
        vec = dict(z.items())
    batches = 0
    _reset(decoder_kernel.launches)
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
    routes = {name: v for name, v in decoder_kernel.launches.items() if v}
    # the frame-major u entry: the tile kernel's (B, N) launch, the walk
    # (transposed) above its level
    if set(routes) != {"fastssc_decoder_u_frames", "walk_decoder_u"}:
        raise AssertionError(f"golden decodes launched {routes}")
    phase("2", f"decoder kernel equals {batches} golden dec_* batches (m=2..14; "
          f"the tile kernel to m={decoder_kernel.WHOLE_MAX_LEVEL}, the walk "
          f"above): launches {routes}")

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
    top = step_kernel.STEP_TILE_MAX_LEVEL
    _reset(step_kernel.launches)
    for level in levels:
        lc = pt.make_code(level, rate=0.5)
        for systematic in (True, False):
            a, b = inject_pair(lc, 512, 1.0, systematic, level)
            if not torch.equal(a, b):
                raise AssertionError(f"inject step differs at m={level} "
                                     f"sys={systematic}")
    tiled = 2 * sum(level <= top for level in levels)
    if (step_kernel.launches["mc_step"], step_kernel.launches["walk_step"]) != (
            tiled, 2 * len(levels) - tiled):
        raise AssertionError(f"inject steps launched {step_kernel.launches}")
    phase("3", f"inject step == plain chain at every level {levels.start}.."
          f"{levels.stop - 1}, both modes, B=512: the tile step to m={top}, "
          f"the walk above (launches {dict(step_kernel.launches)})")

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
    # the tile step against the walk it replaced, on the same Philox words:
    # equal integers at every level of the tile, both modes
    for level, batch in [(lv, 4096) for lv in range(2, top + 1)] + [(10, 999)]:
        lc = pt.make_code(level, rate=0.5)
        for systematic in (True, False):
            kw = dict(seeds=(level, batch), call=4, batch=batch, device=dev)
            run = (pt.compile_program(lc), lc.frozen, snr_params(-1.0),
                   systematic)
            a = step_kernel.step(*run, **kw)
            b = step_kernel.step(*run, style="walk", **kw)
            if not torch.equal(a, b):
                raise AssertionError(f"tile step {a.tolist()} vs walk "
                                     f"{b.tolist()} at m={level} "
                                     f"sys={systematic} B={batch}")
    phase("4", f"native tile step == walk (mc_step_kernel) on the same seeds "
          f"at every level 2..{top}, both modes, B=4096, and m=10 B=999")

    # -- 5. the main path: decode benchmark and BER campaign ---------------
    for counts in (decoder_kernel.launches, step_kernel.launches,
                   decoder_kernel.plain_calls, step_kernel.plain_calls):
        for name in counts:
            counts[name] = 0
    rng = np.random.default_rng(42)
    llrs = torch.from_numpy(
        rng.integers(-128, 128, (BATCH, n)).astype(np.int8)).to(dev)
    # at this code and batch the auto decoder (decode/auto.py) is the
    # scratch style, the tile kernel's u instance at the warps of
    # decoder_kernel.SCRATCH_TABLE; the whole-code kernel by name follows
    for dec, desc in (pt.make_auto_decoder(code, output="u", device=dev),
                      (make_kernel_decoder(code, output="u"), "whole-code")):
        fps = measure_decode_fps(dec, llrs, iters=64)
        phase("5", f"decode benchmark ({desc}): {fps:.1f} frames/s at "
              f"Polar({n}, {k}) B={BATCH}, vs_baseline "
              f"{fps / AVX2_REFERENCE_FPS_N1024:.3f} ({card})")
    t0 = time.perf_counter()
    # the fused step and the whole-code decoder's gauge asked for by name;
    # the run through make_step's default path (the fused step too, by
    # ber.AUTO_STEP_PATH, with no decoder pinned) follows
    res = pt.run_campaign(code, device=dev, seed=5, batch=BATCH,
                          snr_range=(-1.0, 1.0), snr_step=0.2,
                          max_frames_per_point=1 << 17, fused=True,
                          decoder=make_kernel_decoder(code,
                                                      output="systematic"))
    wall = time.perf_counter() - t0
    launched = {name: v for c in (decoder_kernel.launches, step_kernel.launches)
                for name, v in c.items()
                if name in ("fastssc_decoder_u", "fastssc_decoder_cw", "mc_step")}
    # row 1 counts the u track in both layouts: the decode benchmark's
    # frame-major entry launches it on (B, N) LLRs
    launched["fastssc_decoder_u"] += \
        decoder_kernel.launches["fastssc_decoder_u_frames"]
    plain = {**decoder_kernel.plain_calls, **step_kernel.plain_calls}
    walked = decoder_kernel.launches["walk_decoder_u"] + \
        decoder_kernel.launches["walk_decoder_cw"]
    if min(launched.values()) == 0 or max(plain.values()) != 0 or walked:
        raise AssertionError(f"main path launches {launched}, plain calls {plain}")
    phase("5", f"campaign {len(res.points)} points in {wall:.1f} s; launches "
          f"{launched} (walk {walked}); plain calls {plain}; decode gauge "
          f"{res.peak_mbps:.1f} info Mbit/s")
    campaign_vs_reference("5", res, "n1024_sys_int8.json", k, len(res.points))
    # the fused step's main path: a campaign through make_step's default
    # path at this code and FUSED_PATH_BATCH, which ber.AUTO_STEP_PATH
    # sends to the fused step (the tile step); its launches are row 5's
    b_f = FUSED_PATH_BATCH
    path = pt.ber._step_path(code, torch.int8, None, None, "auto", dev,
                             True, b_f)
    if path != "fused":
        raise AssertionError(f"make_step's default at Polar({n}, {k}) "
                             f"B={b_f} is {path!r}, not the fused step")
    _reset(step_kernel.launches, step_kernel.plain_calls)
    t0 = time.perf_counter()
    res = pt.run_campaign(code, device=dev, seed=8, batch=b_f,
                          snr_range=(-1.0, 0.0), snr_step=0.2,
                          max_frames_per_point=4 * b_f,
                          measure_throughput=False)
    wall = time.perf_counter() - t0
    step_launches = dict(step_kernel.launches)
    if (step_launches["mc_step"] == 0 or step_launches["walk_step"]
            or max(step_kernel.plain_calls.values())):
        raise AssertionError(f"default-path campaign launches {step_launches},"
                             f" plain calls {step_kernel.plain_calls}")
    launched["mc_step"] = step_launches["mc_step"]
    phase("5", f"campaign through make_step's default path at "
          f"Polar({n}, {k}) B={b_f}: {len(res.points)} "
          f"points in {wall:.1f} s; step launches {step_launches}; plain calls "
          f"{step_kernel.plain_calls}")
    campaign_vs_reference("5", res, "n1024_sys_int8.json", k, len(res.points))

    # -- 6. timings, kernel against plain version --------------------------
    ms = ms_kept
    frozen = code.frozen
    times, earlier = {}, {}
    for name, want_cw in (("fastssc_decoder_u", False), ("fastssc_decoder_cw", True)):
        # the tile kernel and the walk it replaces at this code, in turns
        tile = lambda: decoder_kernel.decode(program, frozen, llr_t, want_cw)  # noqa: E731
        walk = lambda: decoder_kernel.decode(program, frozen, llr_t, want_cw,  # noqa: E731
                                             "walk")
        t = [ms(tile, 20)]
        w = [ms(walk, 20), ms(walk, 20)]
        t.append(ms(tile, 20))
        times[name] = (
            sum(t) / 2,
            ms(lambda: decoder_kernel.decode_plain(program, frozen, llr_t, want_cw), 3))
        counts = decoder_kernel.plan(program, BATCH, want_cw=want_cw,
                                     layout="lanes")
        earlier[name] = sum(w) / 2
        phase("6", f"{name}: tile kernel {t[0]:.3f}, {t[1]:.3f} ms; walk "
              f"{w[0]:.3f}, {w[1]:.3f} ms ({earlier[name] / times[name][0]:.2f}x) "
              f"at Polar({n}, {k}) B={BATCH}; "
              f"{stages(counts)} ({card})")
    # the fused step: the tile step and the walk it replaces in turns, at
    # the default path's shape (B = BATCH, the kernels line) and at
    # B = 4096, the batch of phase 12's campaign at this code
    counts = tile_stages.step_stages(program, n, True,
                                     tile_stages.block_rows(2, 2))
    for b_t in (4096, BATCH):
        kw = dict(seeds=(99, 98), call=1, batch=b_t, device=dev)
        run = (program, frozen, snr_params(1.0), True)
        tile = lambda: step_kernel.step(*run, **kw)  # noqa: E731
        walk = lambda: step_kernel.step(*run, style="walk", **kw)  # noqa: E731
        t = [ms(tile, 20)]
        w = [ms(walk, 20), ms(walk, 20)]
        t.append(ms(tile, 20))
        phase("6", f"mc_step: tile step {t[0]:.3f}, {t[1]:.3f} ms; walk "
              f"{w[0]:.3f}, {w[1]:.3f} ms ({sum(w) / sum(t):.2f}x) at "
              f"Polar({n}, {k}) B={b_t} systematic; "
              f"{stages(counts)} ({card})")
    times["mc_step"] = (
        sum(t) / 2, ms(lambda: step_kernel.step_plain(*run, **kw), 3))
    earlier["mc_step"] = sum(w) / 2
    for name, (t_k, t_p) in times.items():
        phase("6", f"{name}: kernel {t_k:.3f} ms ({BATCH / t_k * 1e3:.4g} frames/s), "
              f"plain {t_p:.3f} ms ({BATCH / t_p * 1e3:.4g} frames/s) at "
              f"Polar({n}, {k}) B={BATCH} ({card})")

    work = {name: row_work(name, n=n, k=k, b=BATCH)
            for name in ("fastssc_decoder_u", "fastssc_decoder_cw", "mc_step")}
    library, steps, by_shape = {}, {}, {}
    for run in (large_n_phases, draw_phases, front_step_phases, style_phases,
                parallel_phases, module_phases, frame_entry_phases,
                count_frames_phases, interp_frames_phases, f32_decode_phases):
        more = run(dev, card, ms)
        for name, e in more["err"].items():   # a row's checks in any phase
            err[name] = max(err.get(name, 0), e)
        times.update(more["times"])
        work.update(more["work"])
        launched.update(more["launched"])
        library.update(more.get("library", {}))
        earlier.update(more.get("earlier", {}))
        steps.update(more.get("steps", {}))
        for name, shapes in more.get("by_shape", {}).items():
            by_shape.setdefault(name, {}).update(shapes)

    replaces = {
        "fastssc_decoder_u": ("polar_tpu_torch/csrc/decoder.cu",   # + fastssc_simd.cuh
                              "polar_tpu/ops/pallas/decoder_kernel.py:404"),
        "fastssc_decoder_cw": ("polar_tpu_torch/csrc/decoder.cu",
                               "polar_tpu/ops/pallas/decoder_kernel.py:410"),
        "mc_step": ("polar_tpu_torch/csrc/step.cu",
                    "polar_tpu/ops/pallas/step_kernel.py:328"),
        "subtree_decoder": ("polar_tpu_torch/csrc/subtree.cu",
                            "polar_tpu/ops/pallas/decoder_kernel.py:562"),
        "front_blocks_a": ("polar_tpu_torch/csrc/front.cu",
                           "polar_tpu/ops/pallas/step_kernel.py:713"),
        "front_blocks_b": ("polar_tpu_torch/csrc/front.cu",
                           "polar_tpu/ops/pallas/step_kernel.py:762"),
        "count": ("polar_tpu_torch/csrc/count.cu",
                  "polar_tpu/ops/pallas/step_kernel.py:544"),
        "channel_symbols": ("polar_tpu_torch/csrc/channel_grid.cu",
                            "polar_tpu/ops/pallas/channel_kernel.py:77"),
        "channel_awgn": ("polar_tpu_torch/csrc/channel_grid.cu",
                         "polar_tpu/ops/pallas/channel_kernel.py:60"),
        "block_encoder": ("polar_tpu_torch/csrc/encode.cu",
                          "polar_tpu/ops/pallas/encode_kernel.py:52"),
        "front_whole": ("polar_tpu_torch/csrc/front.cu",
                        "polar_tpu/ops/pallas/step_kernel.py:611"),
        "decode_count": ("polar_tpu_torch/csrc/step.cu",
                         "polar_tpu/ops/pallas/step_kernel.py:453"),
        "front_middle": ("polar_tpu_torch/csrc/front.cu",
                         "polar_tpu/ops/pallas/step_kernel.py:800"),
        "scratch_decoder": ("polar_tpu_torch/csrc/scratch.cu",
                            "polar_tpu/ops/pallas/decoder_kernel.py:541"),
        "scratch_subtree": ("polar_tpu_torch/csrc/scratch.cu",
                            "polar_tpu/ops/pallas/decoder_kernel.py:550"),
        "interp_decoder": ("polar_tpu_torch/csrc/interp.cu",
                           "polar_tpu/ops/pallas/interp_kernel.py:409"),
        "interp_decode_count": ("polar_tpu_torch/csrc/interp.cu",
                                "polar_tpu/ops/pallas/interp_kernel.py:569"),
        "interp_subtree": ("polar_tpu_torch/csrc/interp.cu",
                           "polar_tpu/ops/pallas/interp_kernel.py:687"),
        "ring_shift": ("polar_tpu_torch/csrc/ring.cu",
                       "polar_tpu/parallel/rdma.py:61"),
        # no Pallas kernel: the JAX package's draws-path counters are jnp
        "count_frames": ("polar_tpu_torch/csrc/count.cu",
                         "none (polar_tpu/ber.py:394-411, jnp)"),
        # no Pallas kernel: the JAX package's float decode is eager jnp
        "f32_decoder": ("polar_tpu_torch/csrc/decoder.cu",
                        "none (polar_tpu/decode/fastssc.py, FloatArith)"),
    }
    rows = []
    for name, (src, rep) in replaces.items():
        bound_ms, bound_by = bound(*work[name])
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launched[name], "max_abs_err": err[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the other functions: the
            # decoders, the Philox draws and the counters have none, and a
            # polar butterfly over +-1 is no one library call; the ring
            # shift's is Tensor.copy_ per position
            "library_ms": library.get(name)})
        if name in earlier:    # the design this run replaced, same inputs
            rows[-1]["earlier_ms"] = earlier[name]
        if name in steps:      # the main-path steps that made the launches
            rows[-1]["steps"] = steps[name]
        if name in by_shape:   # the same numbers at each shape that launches it
            rows[-1]["by_shape"] = []
            for where, t in by_shape[name].items():
                b_ms, b_by = bound(*t["work"])
                rows[-1]["by_shape"].append({
                    "shape": where, "launches": t["launches"],
                    "steps": t["steps"], "ms": t["ms"],
                    **{key: t[key] for key in ("earlier_ms", "lanes_ms",
                                                "device_ms", "native_ms")
                       if key in t},
                    "plain_ms": t["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by})
                phase("13", f"{name} at {where}: {t['ms']:.4f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by}), {t['launches']} launches in "
                      f"{t['steps']} steps")
        phase("13", f"{name}: {times[name][0]:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {launched[name]} launches on the main path")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
