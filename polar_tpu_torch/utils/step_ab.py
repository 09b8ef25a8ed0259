"""The step A/B on one CUDA device: which Monte-Carlo step to run at each
level.

For Polar(2^m, 2^(m-1)) int8 at ``SNR_DB``, systematic and plain, m in
``--levels`` (10..17 by default), it measures frames/s with
:func:`~polar_tpu_torch.utils.benchmark.measure_step_rate` over chained
steps, at B = 32768 for m <= 14 and B = 4096 at every level, of each arm
that applies:

* ``fused`` — the fused step kernel (m <= 16: the tile step up to
  ``step_kernel.STEP_TILE_MAX_LEVEL``, the walk above);
* ``fused walk`` — the fused step's walk by name, where ``fused`` is the
  tile step (the design the tile step replaced);
* ``whole+count`` — the whole-block front, then decode+count (systematic);
* ``block+whole`` — the block front, the whole-code kernel decoder's
  lane-major entry, the counter kernel (systematic) or torch u counters
  (plain), m <= 14;
* ``block+hybrid`` — the same with the hybrid decoder
  (:func:`~polar_tpu_torch.decode.auto.hybrid_kernel_level`);
* ``block+interp`` — the block front, then the interpreter decode+count
  (systematic);
* ``draws`` — the kernel draws around
  :func:`~polar_tpu_torch.decode.auto.make_auto_decoder`'s decoder,
  pinned;
* ``block+whole ssa``, ``block+hybrid ssa`` and ``draws ssa`` — the same
  with the SSA-style decoders alone (``kernel_style="ssa"``;
  ``make_named_decoder``), where
  :data:`~polar_tpu_torch.decode.auto.AUTO_DECODERS` picks another style at
  this level;
* ``draws interp`` — the kernel draws around the whole-code interpreter
  (m = 9..17), where
  :data:`~polar_tpu_torch.decode.auto.AUTO_DECODERS` does not name it at
  both batches.

Arms run in order, then in reverse order (a drift shows as two readings
apart). Then, at B = 4096, the fronts alone by CUDA events: the
whole-block front, the block front with the kernel middle and with the
torch middle, the block front at block levels 8 and 12 as well as the
default
(``front_kernel.BLOCK_LEVEL``), and each middle by itself
(``--fronts-only`` for these alone). Before the steps, the decoders alone, the
choice of :data:`~polar_tpu_torch.decode.auto.HYBRID_MIN_LEVEL` and of a
kernel style: one decode of full-range int8 LLRs, u and codeword outputs,
frame-major and lane-major entries, at both batches, in mirrored order, by
the whole-code kernel (m <= 14: the tile kernel up to
``decoder_kernel.WHOLE_MAX_LEVEL``, the walk above), the walk by name (m <=
``WHOLE_MAX_LEVEL``), the hybrid at
:func:`~polar_tpu_torch.decode.auto.hybrid_kernel_level`, the scratch
whole-code kernel (u, m <= 11), the interpreter's tile kernel at subtree
levels 9 and 10 (m = 9..17) and the hybrid at kernel level 9 in the walk,
scratch and interpreter styles (m = 13..17; the SSA style's subtree kernel
is the tile kernel, the walk the one it replaced). ``--scratch-shapes`` times the
scratch tile kernel alone at every shape and block size
(:func:`scratch_shape_rows`), the source of
``decoder_kernel.SCRATCH_TABLE``. ``--arms`` times only the step arms it
names (comma-separated, e.g. ``block+interp,block+hybrid``), no decoders
or fronts; with ``--decoders-only``, only the decoders it names.
``--batches`` (comma-separated) takes the place of each level's batches;
``--systematic-only`` leaves out the plain steps. ``--front-warps`` times
the whole front alone at each level and batch: the row-word kernel at 1, 2,
4 and 8 warps a CTA (up to its cap) and the thread kernel it replaced, in
mirrored order (:func:`front_warp_rows`, the source of
``step_kernel.front_rows_warps``' rule); ``--count-warps`` times
decode+count alone the same way: the tile kernel at 1, 2, 4 and 8 tiles a
block (where they fit) and the walk (:func:`count_warp_rows`, the source
of ``step_kernel.COUNT_BIG_WARPS``). Every line
names the card and its power limit; ``--out`` also writes the readings as
JSON lines.

    python -m polar_tpu_torch.utils.step_ab [--levels 10-17] [--out FILE]
    python -m polar_tpu_torch.utils.step_ab --decoders-only --levels 9-17
    python -m polar_tpu_torch.utils.step_ab --fronts-only --levels 14-17
    python -m polar_tpu_torch.utils.step_ab --scratch-shapes --levels 1-11
    python -m polar_tpu_torch.utils.step_ab --front-warps --levels 6-13 \
        --batches 4096,32768
    python -m polar_tpu_torch.utils.step_ab --levels 13-17 \
        --arms block+interp,block+hybrid
    python -m polar_tpu_torch.utils.step_ab --decoders-only --levels 15-17 \
        --batches 16384 --arms "interp sl10,hybrid kl9"
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SNR_DB = -1.5
BIG_BATCH = 32768
BIG_BATCH_MAX_LEVEL = 14
BATCH = 4096
WHOLE_DECODER_MAX_LEVEL = 14
INTERP_LEVELS = (9, 17)          # the whole-code interpreter's arms
INTERP_SUBTREE_LEVELS = (9, 10)
STYLE_HYBRID_MIN_LEVEL = 13      # the hybrid's other styles' arms


def _levels(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def arms(code, systematic: bool, device) -> dict:
    """The steps to compare at this code, by arm name."""
    import polar_tpu_torch as pt
    from polar_tpu_torch import ber
    from polar_tpu_torch.decode import auto as decode_auto
    from polar_tpu_torch.ops.cuda import step_kernel

    level = code.level
    out = {}
    if level <= ber.STEP_KERNEL_MAX_LEVEL:
        out["fused"] = ber.make_step(code, systematic=systematic, fused=True,
                                     device=device)
    if step_kernel.step_kernel_name(code.N) == "tile":
        out["fused walk"] = ber.make_step(code, systematic=systematic,
                                          fused=True, step_style="walk",
                                          device=device)
    branches = ["block-hybrid"]
    if level <= WHOLE_DECODER_MAX_LEVEL:
        branches.insert(0, "block-whole")
    if systematic:
        branches.insert(0, "whole")
        branches.append("block-interp")
    for branch in branches:
        name = ("whole+count" if branch == "whole"
                else branch.replace("-", "+"))
        out[name] = ber.make_front_step(code, systematic=systematic,
                                        branch=branch, middle_mode="kernel",
                                        device=device)
    for branch in branches:  # the front decoders in the SSA style alone
        if branch in ("block-whole", "block-hybrid") and any(
                decode_auto.kernel_style(level, systematic, b,
                                         branch == "block-hybrid") != "ssa"
                for b in (BATCH, BIG_BATCH)):
            out[branch.replace("-", "+") + " ssa"] = ber.make_front_step(
                code, systematic=systematic, branch=branch,
                kernel_style="ssa", middle_mode="kernel", device=device)
    output = "systematic" if systematic else "u"
    decs = {"draws": pt.make_auto_decoder(code, output=output,
                                          device=device)[0]}
    if (level, systematic) in decode_auto.AUTO_DECODERS:
        ssa = "hybrid" if level >= decode_auto.HYBRID_MIN_LEVEL else "ssa"
        decs["draws ssa"] = decode_auto.make_named_decoder(code, ssa,
                                                           output)[0]
    if (INTERP_LEVELS[0] <= level <= INTERP_LEVELS[1] and
            decode_auto.decoder_names(level, systematic) != ("interp",) * 2):
        decs["draws interp"] = decode_auto.make_named_decoder(code, "interp",
                                                              output)[0]
    for name, dec in decs.items():
        out[name] = ber.make_step(code, systematic=systematic, decoder=dec,
                                  device=device)
    return out


def rate(step, batch: int, device, seed: int) -> float:
    """Frames/s of ``step`` by the chained slope method, after one warm-up
    step; the chain length aims at about a second per timed run."""
    import torch

    from polar_tpu_torch.utils.benchmark import measure_step_rate

    gen = torch.Generator()
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    int(step(gen, SNR_DB, batch)["uncorrected_errors"])
    one = time.perf_counter() - t0
    iters = max(2, min(16, int(1.0 / max(one, 1e-3))))
    return measure_step_rate(step, gen, SNR_DB, batch, device=device,
                             iters=iters, repeats=2, warmup=False,
                             max_iters=4 * iters)


def front_times(code, device, ms) -> dict:
    """ms of the fronts alone at B = BATCH, systematic, native words."""
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.ops.cuda import front_kernel, step_kernel

    frozen, params = code.frozen, snr_params(SNR_DB)
    kw = dict(seeds=(3, 4), call=0, batch=BATCH, device=device)
    out = {}
    if code.level <= 16:
        out["whole front"] = ms(lambda: step_kernel.front(frozen, params, **kw))
    for mode in ("kernel", "torch"):
        out[f"block front, {mode} middle"] = ms(
            lambda: front_kernel.front_blocks(frozen, params, True,
                                              middle_mode=mode, **kw))
    for level in (8, 12):
        if level < code.level:
            out[f"block front, blocks 2^{level}"] = ms(
                lambda: front_kernel.front_blocks(
                    frozen, params, True, block_level=level,
                    chan_block_level=level, **kw))
    blk_a = 1 << min(front_kernel.BLOCK_LEVEL, code.level)
    blk_b = 1 << min(front_kernel.CHAN_BLOCK_LEVEL, code.level)
    x = front_kernel.msg_blocks(frozen, blk_a, True, **kw)
    for name, fn in (("middle kernel", front_kernel.middle_kernel),
                     ("middle torch", front_kernel.middle_plain)):
        out[name] = ms(lambda: fn(x, frozen, blk_a, blk_b, True))
    return out


def front_warp_rows(levels, batches, device, ms) -> list[dict]:
    """ms of the whole front (native words, systematic) by arm at each
    level and batch: ``rows wG`` the row-word kernel at G warps a CTA,
    ``thread`` the kernel it replaced; each arm twice, in mirrored order."""
    import polar_tpu_torch as pt
    from polar_tpu_torch.channel import snr_params
    from polar_tpu_torch.ops.cuda import step_kernel

    rows = []
    params = snr_params(SNR_DB)
    for level in levels:
        frozen = pt.make_code(level, rate=0.5).frozen
        cap = step_kernel.front_rows_warps(1 << level)
        for batch in _batches(level, batches):
            kw = dict(seeds=(3, 4), call=0, batch=batch, device=device)
            arms = {f"rows w{w}": dict(warps=w) for w in (1, 2, 4, 8)
                    if w <= cap}
            arms["thread"] = dict(style="thread")
            got = {name: [] for name in arms}
            for name in list(arms) + list(arms)[::-1]:
                got[name].append(ms(lambda: step_kernel.front(
                    frozen, params, **kw, **arms[name])))
            rule = step_kernel.front_rows_warps(1 << level)
            for name, t in got.items():
                rows.append(dict(level=level, batch=batch, front=name, ms=t,
                                 rule=f"rows w{rule}"))
    return rows


def count_warp_rows(levels, batches, device, ms) -> list[dict]:
    """ms of decode+count (full-range int8 LLRs, a systematic codeword) by
    arm at each level and batch: ``tile wG`` the tile kernel at G tiles a
    block (where G tiles fit a block's shared memory), ``walk`` the kernel
    it replaced; each arm twice, in mirrored order."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import decoder_kernel, step_kernel

    rows = []
    for level in levels:
        code = pt.make_code(level, rate=0.5)
        program = pt.compile_program(code)
        fit = (decoder_kernel.SCRATCH_SMEM_BYTES
               // decoder_kernel.tile_bytes(code.N, True))
        for batch in _batches(level, batches):
            g = torch.Generator(device=device)
            g.manual_seed(level)
            llr = torch.randint(-128, 128, (code.N, batch), generator=g,
                                device=device, dtype=torch.int8)
            cw = step_kernel.front(code.frozen, (1.0, 2.0), seeds=(1, 2),
                                   batch=batch, device=device)[1]
            arms = {f"tile w{w}": dict(warps=w) for w in (1, 2, 4, 8)
                    if w <= fit}
            arms["walk"] = dict(style="walk")
            got = {name: [] for name in arms}
            for name in list(arms) + list(arms)[::-1]:
                got[name].append(ms(lambda: step_kernel.decode_count(
                    program, code.frozen, llr, cw, **arms[name])))
            rule = step_kernel.decode_count_warps(code.N, batch)
            for name, t in got.items():
                rows.append(dict(level=level, batch=batch, count=name, ms=t,
                                 rule=f"tile w{rule}"))
    return rows


def _batches(level: int, batches=None) -> list[int]:
    if batches:
        return list(batches)
    return [BIG_BATCH, BATCH] if level <= BIG_BATCH_MAX_LEVEL else [BATCH]


def decoders(code, output: str) -> dict:
    """The decoders to time at this code, by name (see the module
    docstring)."""
    import torch

    from polar_tpu_torch.decode.auto import (hybrid_kernel_level,
                                             make_kernel_decoder)
    from polar_tpu_torch.decode.fastssc import make_fastssc_decoder
    from polar_tpu_torch.ops.cuda import decoder_kernel
    from polar_tpu_torch.ops.cuda.interp_kernel import make_interp_decoder

    level, kl = code.level, hybrid_kernel_level(code.level)
    out = {}
    if level <= WHOLE_DECODER_MAX_LEVEL:
        out["whole-code"] = make_kernel_decoder(code, output=output)
    if level <= decoder_kernel.WHOLE_MAX_LEVEL:   # whole-code is the tile kernel
        out["walk"] = make_kernel_decoder(code, output=output, style="walk")
    if output == "u" and level <= decoder_kernel.SCRATCH_MAX_LEVEL:
        out["scratch"] = make_kernel_decoder(code, style="scratch")
    if INTERP_LEVELS[0] <= level <= INTERP_LEVELS[1]:
        for sl in INTERP_SUBTREE_LEVELS:
            out[f"interp sl{sl}"] = make_interp_decoder(
                code, subtree_level=sl, output=output)
    styles = (("ssa", "walk", "scratch", "interp")
              if level >= STYLE_HYBRID_MIN_LEVEL else ("ssa",))
    for style in styles:
        name = f"hybrid kl{kl}" + ("" if style == "ssa" else f" {style}")
        out[name] = make_fastssc_decoder(code, output=output,
                                         output_dtype=torch.int8,
                                         kernel_level=kl, kernel_style=style)
    return out


SHAPE_BATCHES = (4096, 16384, 32768)   # --scratch-shapes
SHAPE_NODE_LEVEL = 9             # the hybrid kl9's nodes
SHAPE_NODE_BATCHES = (4096, 16384)


def scratch_arms(level: int) -> list:
    """The scratch tile kernel's (wr, vw, warps) at this level: every shape
    of ``decoder_kernel.SCRATCH_SHAPES`` at 1, 2, 4 and 8 warps a block,
    where a block's shared memory holds them."""
    from polar_tpu_torch.ops.cuda import decoder_kernel as dk

    return [(wr, vw, warps) for wr, vw in dk.SCRATCH_SHAPES
            for warps in (1, 2, 4, 8)
            if dk.scratch_smem(1 << level, wr, warps) <= dk.SCRATCH_SMEM_BYTES]


def scratch_shape_rows(levels, device, reps: int = 20) -> list[dict]:
    """Device ms of one scratch decode (u) by every arm of
    :func:`scratch_arms` and the SSA style's kernel: the whole code Polar(2^m, 2^(m-1)) at
    :data:`SHAPE_BATCHES` for m in ``levels`` (m <= 11), then the largest
    level-9 node of Polar(131072, 65536)'s hybrid at
    :data:`SHAPE_NODE_BATCHES`. Each arm is timed in order and in reverse
    order by ``queued_seconds`` (host time hidden)."""
    import torch

    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import decoder_kernel as dk
    from polar_tpu_torch.ops.cuda import subtree_kernel
    from polar_tpu_torch.utils.benchmark import queued_seconds

    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    cases = []
    for level in levels:
        if level > dk.SCRATCH_MAX_LEVEL:
            continue
        code = pt.make_code(level, rate=0.5)
        program = pt.compile_program(code)
        for batch in SHAPE_BATCHES:
            def arm(style, shape=None, code=code, program=program):
                return lambda x: dk.decode(program, code.frozen, x, False,
                                           style, shape)
            arms = {"ssa": arm("ssa")}
            arms.update({f"{wr}x{vw} w{warps}": arm("scratch",
                                                    (wr, vw, warps))
                         for wr, vw, warps in scratch_arms(level)})
            cases.append((f"m={level}", level, batch, arms))
    big = pt.make_code(17, rate=0.5)
    node, stack = None, [pt.compile_code(big)]
    while stack:     # the largest composite level-9 node, as chip_smoke's (b')
        nd = stack.pop()
        if nd.level == SHAPE_NODE_LEVEL and nd.mesg_bits >= 1 and nd.kind in (
                "branch", "rate0_right", "rate1_comb"):
            if node is None or nd.mesg_bits > node.mesg_bits:
                node = nd
            continue
        stack.extend(c for c in (nd.left, nd.right) if c is not None)
    for batch in SHAPE_NODE_BATCHES:
        sub = subtree_kernel.make_subtree_decoder
        arms = {"ssa": sub(node, style="ssa")}
        arms.update({f"{wr}x{vw} w{warps}": sub(node, style="scratch",
                                                shape=(wr, vw, warps))
                     for wr, vw, warps in scratch_arms(node.level)})
        cases.append((f"node level {node.level} k={node.mesg_bits}",
                      node.level, batch, arms))
    rows = []
    for what, level, batch, arms in cases:
        x = torch.randint(-128, 128, (1 << level, batch), generator=gen,
                          device=device, dtype=torch.int8)
        got = {name: [] for name in arms}
        names = list(arms)
        for name in names + names[::-1]:
            got[name].append(queued_seconds(lambda: arms[name](x), reps) * 1e3)
        for name in names:
            rows.append(dict(case=what, level=level, batch=batch, arm=name,
                             ms=got[name]))
        del x
    return rows


def decoder_times(code, device, ms, only=None, batches=None) -> list[dict]:
    """ms of one decode by each of :func:`decoders` (those named in
    ``only`` if given), each run once first, then timed in order and in
    reverse order, at ``batches`` or the level's own."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(code.level)
    rows = []
    for batch in _batches(code.level, batches):
        llr_t = torch.randint(-128, 128, (code.N, batch), generator=gen,
                              device=device, dtype=torch.int8)
        llrs = llr_t.t().contiguous()
        for output in ("u", "codeword"):
            decs = {name: d for name, d in decoders(code, output).items()
                    if only is None or name in only}
            for entry in ("frame-major", "lane-major"):
                fns = {name: ((lambda d=d: d(llrs)) if entry == "frame-major"
                              else (lambda d=d: d.lane_major(llr_t)))
                       for name, d in decs.items()}
                names = list(fns)
                got = {name: [] for name in names}
                for fn in fns.values():   # every arm once before any reading
                    fn()
                torch.cuda.synchronize()
                for name in names + names[::-1]:
                    got[name].append(ms(fns[name]))
                for name in names:
                    rows.append(dict(level=code.level, batch=batch,
                                     output=output, entry=entry, decoder=name,
                                     ms=got[name]))
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", default="10-17", help="m range, e.g. 10-17")
    ap.add_argument("--out", default=None, help="JSON lines to this file")
    ap.add_argument("--decoders-only", action="store_true",
                    help="time the decoders alone, no steps or fronts")
    ap.add_argument("--fronts-only", action="store_true",
                    help="time the fronts alone, no decoders or steps")
    ap.add_argument("--scratch-shapes", action="store_true",
                    help="time the scratch tile kernel's shapes alone")
    ap.add_argument("--arms", default=None,
                    help="only these step arms (with --decoders-only, these "
                    "decoders), comma-separated")
    ap.add_argument("--batches", default=None,
                    help="these batches at every level, comma-separated")
    ap.add_argument("--systematic-only", action="store_true",
                    help="no plain steps")
    ap.add_argument("--front-warps", action="store_true",
                    help="time the whole front's warps a CTA alone")
    ap.add_argument("--count-warps", action="store_true",
                    help="time decode+count's tiles a block alone")
    args = ap.parse_args(argv)
    only = None if args.arms is None else set(args.arms.split(","))
    batches = (None if args.batches is None
               else [int(b) for b in args.batches.split(",")])
    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
        return 1
    import polar_tpu_torch as pt
    from polar_tpu_torch.utils.benchmark import elapsed_seconds

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(card, flush=True)
    rows = []

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        return elapsed_seconds(lambda: [fn() for _ in range(reps)], dev) / reps * 1e3

    def ms_dropped(fn, reps=5):
        """As ms, each output dropped as the next call starts: a front's
        outputs are N x B bytes each, and kept alive they would make each
        launch wait for the allocator's new blocks."""
        def run():
            for _ in range(reps):
                fn()

        fn()
        torch.cuda.synchronize()
        return elapsed_seconds(run, dev) / reps * 1e3

    if args.scratch_shapes:
        for row in scratch_shape_rows(_levels(args.levels), dev):
            rows.append(dict(row, card=card))
            print(f"{row['case']} B={row['batch']} scratch {row['arm']}: "
                  f"{', '.join(f'{t:.4f}' for t in row['ms'])} ms", flush=True)
    if args.front_warps:
        for row in front_warp_rows(_levels(args.levels), batches, dev,
                                   ms_dropped):
            rows.append(dict(row, card=card))
            print(f"m={row['level']} B={row['batch']} whole front "
                  f"{row['front']}: {', '.join(f'{t:.4f}' for t in row['ms'])}"
                  f" ms (rule: {row['rule']})", flush=True)
    if args.count_warps:
        for row in count_warp_rows(_levels(args.levels), batches, dev,
                                   ms_dropped):
            rows.append(dict(row, card=card))
            print(f"m={row['level']} B={row['batch']} decode+count "
                  f"{row['count']}: {', '.join(f'{t:.4f}' for t in row['ms'])}"
                  f" ms (rule: {row['rule']})", flush=True)
    for level in ([] if args.scratch_shapes or args.front_warps
                  or args.count_warps else _levels(args.levels)):
        code = pt.make_code(level, rate=0.5)
        if args.fronts_only or (only is not None and not args.decoders_only):
            pass
        elif level <= WHOLE_DECODER_MAX_LEVEL or args.decoders_only:
            for row in decoder_times(code, dev, ms, only, batches):
                rows.append(dict(row, card=card))
                print(f"m={level} B={row['batch']} decode {row['output']} "
                      f"{row['entry']} {row['decoder']}: "
                      f"{', '.join(f'{t:.3f}' for t in row['ms'])} ms",
                      flush=True)
            torch.cuda.empty_cache()
        if args.decoders_only:
            continue
        for systematic in (() if args.fronts_only else (True,)
                           if args.systematic_only else (True, False)):
            steps = {name: step for name, step in
                     arms(code, systematic, dev).items()
                     if only is None or name in only}
            for batch in _batches(level, batches) if steps else ():
                names = list(steps)
                got = {name: [] for name in names}
                for name in names + names[::-1]:
                    got[name].append(rate(steps[name], batch, dev, level))
                best = max(names, key=lambda nm: min(got[nm]))
                for name in names:
                    row = dict(level=level, systematic=systematic, batch=batch,
                               arm=name, frames_per_s=got[name], card=card)
                    rows.append(row)
                    print(f"m={level} {'sys' if systematic else 'plain'} "
                          f"B={batch} {name}: "
                          f"{', '.join(f'{r:.1f}' for r in got[name])} frames/s"
                          f"{'  <- best' if name == best else ''}", flush=True)
            del steps
            torch.cuda.empty_cache()
        for name, t in (front_times(code, dev, ms_dropped).items()
                        if only is None else ()):
            rows.append(dict(level=level, batch=BATCH, front=name, ms=t,
                             card=card))
            print(f"m={level} B={BATCH} {name}: {t:.3f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
