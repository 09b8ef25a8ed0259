"""Monte-Carlo BER/FER campaign harness.

The port of ``polar_tpu.ber`` (the reference test bench's measurement
loop, ``testbench.cc:105-221``): for each SNR point, run batches of random
frames through encode → AWGN → quantize → decode → compare, and count the
four diagnostic counters plus frame errors:

* ``awgn_errors``            — channel-induced sign flips (post-quantizer)
* ``quantization_erasures``  — LLRs quantized to exactly 0
* ``uncorrected_errors``     — decoded info bits disagreeing with the message
* ``ambiguity_erasures``     — decoded info bits equal to 0

Randomness comes from explicit generators: the campaign's seed seeds a
host generator, which draws one seed per SNR point; each step draws its
own seed words from the point's generator. Every point is therefore a
pure function of (seed, point index), as checkpoint/resume needs.

One step runs a whole frame batch. For int8 codes without a pinned
decoder, :data:`AUTO_STEP_PATH` picks by level, mode and batch, from the
H100 step A/B, between the fused step
(:mod:`polar_tpu_torch.ops.cuda.step_kernel`), the kernel draws around
the auto decoder and the element-major front path
(``polar_tpu/ber.py:186-279``, ``:323-359``): a front (the whole-block
front kernel, or the block front of
:mod:`~polar_tpu_torch.ops.cuda.front_kernel`), then decode+count, or a
lane-major decoder (whole-code or hybrid) and, when systematic, the
counter kernel (:mod:`~polar_tpu_torch.ops.cuda.count_kernel`); see
:func:`front_branch`. Each runs its CUDA kernels on a card and their plain
versions on the CPU. A decoder pinned by the caller keeps the chain of
:func:`make_step_body` around it: on a card its message, encode and noise
come from the symbols, block-encoder and AWGN kernels
(:mod:`~polar_tpu_torch.ops.cuda.channel_kernel`,
:mod:`~polar_tpu_torch.ops.cuda.encode_kernel`), the JAX package's
second rung (``polar_tpu/ber.py:497-508``); on the CPU, and for every
other configuration, the torch draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .channel import awgn_llrs, ebn0_db, snr_params
from .code.compiler import compile_program
from .code.construction import PolarCode, design_snr_db
from .decode import auto as decode_auto
from .decode.auto import (hybrid_kernel_level, make_auto_decoder,
                          make_kernel_decoder)
from .decode.fastssc import make_fastssc_decoder
from .encode import encode, encode_systematic
from .ops.cuda import (channel_kernel, count_kernel, encode_kernel,
                       front_kernel, interp_kernel, step_kernel)
from .utils.benchmark import measure_decode_fps
from .utils.profiling import annotate

# Levels at which make_step runs the fused step kernel for int8 codes. Up to
# step_kernel.STEP_TILE_MAX_LEVEL that is the tile step; above it the walk,
# which keeps every frame's columns in device memory, so no level is
# excluded by on-chip memory; the ceiling is the largest level checked on
# the card against the plain chain (chip_smoke.py, phase 3).
STEP_KERNEL_MIN_LEVEL = 2
STEP_KERNEL_MAX_LEVEL = 16

# make_step's "auto" path for int8 codes without a pinned decoder, by
# (level, systematic): the path of a step of fewer than AUTO_BIG_BATCH
# frames, then the path from AUTO_BIG_BATCH on; each "fused", "front" or
# "draws" (the kernel draws around make_auto_decoder's decoder, on a card).
# Levels not listed (above 17: not measured) take the front path. From the
# step A/B (python -m polar_tpu_torch.utils.step_ab --levels 6-16, and
# --levels 10-17 for m = 17; -1.5 dB; frames/s, the mean of two readings,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md's table): the best arm at B = 4096
# and at B = 32768 (m <= 14), the fused step kept where it is within 1 %.
# - m <= 9: fused, both modes (m = 9 systematic 4.96M at B = 4096 against the
#   whole front's 4.56M, 24.1M at 32768 against 24.3M; plain 7.35M / 32.9M
#   against the draws' 6.01M / 23.0M); m < 6 not measured;
# - m = 10: fused at 4096 (systematic 1.97M against the front's 1.98M,
#   plain 2.77M against the draws' 2.19M), the draws at 32768 (8.08M against
#   the front's 6.53M, plain 10.1M against the fused step's 8.44M);
# - systematic m = 11, 12: the front at 4096 (1.27M, 748k against the draws'
#   1.14M, 527k), the draws at 32768 (3.67M, 1.70M against 2.87M, 1.68M);
#   m = 13 the front (357.5k / 850.1k against 337.2k / 782.1k); m = 14 the
#   draws at 4096 (199.8k against 176.8k), the front at 32768 (397.0k
#   against 365.1k); m = 15 the draws (99.51k against 97.09k); m = 16, 17 the
#   front (50.99k against 49.46k; 25.53k against 24.65k);
# - plain m >= 11: the draws, by 1-47 % (m = 14 267.3k / 423.4k against the
#   front's 233.5k / 419.8k; m = 17 31.30k against 30.99k).
# AUTO_BIG_BATCH lies between the two batches measured; no batch between
# them was timed. The step A/B with the decoder styles of
# decode.auto.AUTO_DECODERS (--levels 9-12, 13-17; same card) moved plain
# m = 9, 10 below AUTO_BIG_BATCH to the draws around the scratch u decoder
# (10.42M, 5.27M frames/s against the fused step's 7.39M, 2.74M); it left
# every other cell where it was. With the tile kernel as the whole-code
# decoder (step_ab --levels 6-13, then 8-9 and 13 after decode.auto's table
# moved; same card) three cells moved by the same rule and one moved back:
# - systematic m = 9 to the front, now block-whole (FRONT_WHOLE_MAX_LEVEL):
#   6.84M / 35.33M against the fused step's 4.96M / 24.72M (the first call:
#   6.76M / 35.51M against 5.00M / 24.49M);
# - systematic m = 10 below AUTO_BIG_BATCH to the draws: 3.57M against the
#   fused step's 1.94M;
# - systematic m = 13 below AUTO_BIG_BATCH to the draws: 741.0k against the
#   front's 673.1k (at 32768 the front, 852.8k, came within 1.1 % of
#   block-hybrid's 861.7k, which front_branch gives only from m = 14);
# - plain m = 9 below AUTO_BIG_BATCH back to the fused step: 7.39M against
#   the draws' 4.87M (the first call: 7.46M against 4.98M).
# With the tile step as the fused step (step_ab --levels 6-14, the walk an
# arm, "fused walk"; same card) the fused step took every cell from m = 6 to
# 11 and plain m = 12 below AUTO_BIG_BATCH, by 5-266 % (frames/s, B = 4096
# / 32768):
# - systematic m = 9: 24.98M / 71.79M against block-whole's 6.82M / 34.87M
#   (the walk 4.95M / 24.47M);
# - m = 10: systematic 15.94M / 21.93M against the draws' 4.96M / 12.95M,
#   plain 16.75M / 33.62M against 4.79M / 15.94M (the walk 1.93M / 5.28M,
#   2.70M / 8.56M);
# - m = 11: systematic 4.32M / 6.38M against the draws' 3.87M / 5.81M, plain
#   9.59M / 9.85M against 5.29M / 7.29M;
# - plain m = 12 below AUTO_BIG_BATCH: 2.61M against the draws' 2.50M.
# At m = 12 one systematic tile fills an SM's shared memory and the tile
# step trailed: systematic m = 12 went to the draws (2.12M / 2.27M against
# block-whole's 1.88M / 2.20M and the fused step's 1.18M / 1.19M), plain
# m = 12 from AUTO_BIG_BATCH stayed with them (3.13M against 2.66M). A
# second call (--levels 13-17, with decode.auto's table moved to the tile
# hybrid; a path moves where another leads it by more than 1 %; where both
# calls ran the same arms, their mean):
# - systematic m = 13 from AUTO_BIG_BATCH to the draws: 925.5k against the
#   front's (block-whole) 851.4k; block-hybrid read 1023.9k, but
#   front_branch gives the hybrid only from HYBRID_MIN_LEVEL;
# - systematic m = 14 below AUTO_BIG_BATCH to the front (block-hybrid):
#   252.0k against the draws' 242.1k (245.6-235.5k / 205.8-190.9k in the
#   second call, 279-248k / 321-252k in the first);
# - systematic m = 16 to the draws: 66.6k against the front's 59.4k;
# - plain m = 16 to the front: 82.7k against the draws' 73.4k;
# and left plain m = 14 below AUTO_BIG_BATCH with the draws (288.3k against
# the front's 267.8k over both calls; the second alone 213.6k against
# 225.5k), systematic m = 15 (the front 127.0k against 126.5k, 0.4 %) and
# plain m = 15, 17 (the front 133.0k against 135.0k; 39.4k against 39.6k).
# With the interpreter's tile kernel as the front's decode+count
# (front_branch's "block-interp"; step_ab --levels 13-17 --arms fused,
# draws, whole+count, block+whole, block+hybrid, block+interp; same card;
# the mean of two readings, B = 4096 / 32768, the draws around the
# decoders of decode.auto's table before it named the interpreter) the
# front took every systematic cell from m = 13 to 17, by 2.3-3.6x over
# the next arm:
# - m = 13 from the draws: 2.087M / 3.138M against the draws' 724.7k /
#   975.4k (block-whole 1.064M / 1.081M, block-hybrid 512.4k / 1.371M);
# - m = 14 (the front already): 1.024M / 1.465M against block-hybrid's
#   351.1k / 581.0k and the draws' 344.0k / 433.1k;
# - m = 15, 16 below AUTO_BIG_BATCH from the draws: 499.8k, 243.2k against
#   the draws' 149.5k, 69.8k and block-hybrid's 162.2k, 75.0k;
# - m = 17 (the front already): 118.4k against block-hybrid's 39.3k and
#   the draws' 32.8k.
# A second call with the interpreter in decode.auto's table at m = 13..17
# (--arms draws,"draws interp",block+hybrid,block+interp; --batches
# 4096,16384 at m = 15..17; "draws interp" the draws around the
# interpreter where the table named another decoder) kept the front first
# in every systematic cell, by 1.7-2.1x over the draws around the
# interpreter: m = 13 2.451M / 3.671M against 1.366M / 1.783M, m = 14
# 1.224M / 1.732M against 699.2k / 862.4k (B = 4096 / 32768); at
# B = 4096 / 16384 m = 15 595.2k / 804.1k against 351.4k / 416.0k,
# m = 16 291.5k / 377.9k against 174.0k / 200.9k, m = 17 141.7k / 177.9k
# against 85.3k / 97.7k (m = 15, 16 from AUTO_BIG_BATCH from the draws).
# The draws around the interpreter led every plain cell, by 1.8-2.4x over
# block-hybrid (m = 16 from the front: 197.8k / 233.8k against 91.3k /
# 108.5k; m = 13 2.077M at B = 32768 against 1.185M).
# With the row-word whole front and the tile decode+count as the front's
# whole branch (step_ab --levels 6-13 --systematic-only --batches
# 4096,32768 --arms fused,draws,whole+count,block+count,block+whole,
# block+interp; same card, 700.00 W; the mean of two readings, frames/s at
# B = 4096 / 32768) the front took these systematic cells, by the same
# rule, FRONT_WHOLE_MAX_LEVEL moving to 11 (below):
# - m = 8 from AUTO_BIG_BATCH: whole+count 167.4M against the fused step's
#   162.9M (2.7 %; the front's two readings 182.5M and 152.3M);
# - m = 9, 10 from AUTO_BIG_BATCH: whole+count 96.06M, 36.67M against the
#   fused step's 72.58M, 22.26M;
# - m = 11: whole+count 11.34M / 11.91M against the fused step's 4.41M /
#   6.50M;
# - m = 12 from the draws: the front (block-whole) 3.66M / 3.76M against
#   2.22M / 2.42M;
# and left m = 6..10 below AUTO_BIG_BATCH and m = 6, 7 from it with the
# fused step (m = 10: 15.83M against whole+count's 14.20M; m = 7 at 32768:
# 245.9M against 185.1M). block+interp led at m = 11 from AUTO_BIG_BATCH
# (15.63M) and at m = 12 (4.71M / 7.67M), but front_branch gives it only
# where decode.auto's table names the interpreter (m >= 13).
# With the draws step's five counters as one kernel (count_kernel.
# count_frames; step_ab --levels 9-12 --arms fused,draws,whole+count,
# block+whole twice, --levels 11-13 with block+hybrid as well, --levels
# 13-17 --systematic-only --arms draws,block+interp; same card; the mean
# of the readings, frames/s at B = 4096 / 32768) three plain cells moved
# to the draws:
# - plain m = 10 from AUTO_BIG_BATCH: 50.36M against the fused step's
#   34.31M;
# - plain m = 11 from AUTO_BIG_BATCH: 17.98M against the fused step's
#   10.10M;
# - plain m = 12 below AUTO_BIG_BATCH: 4.46M against the fused step's
#   2.69M;
# and every other cell stayed: plain m = 9, 10, 11 below AUTO_BIG_BATCH
# with the fused step (13.87M, 13.39M, 9.69M against the draws' 8.09M,
# 8.86M, 7.98M), plain m = 9 from it (94.25M against 72.34M), and every
# systematic cell with its fused step or front, the draws 1.2-2.9x behind
# (m = 11, 12 the front 10.74M / 11.82M, 3.69M / 3.76M against 3.66M /
# 8.20M, 2.21M / 3.05M; m = 13, 14 block-interp 2.43M / 3.65M, 1.22M /
# 1.72M against 1.72M / 2.72M, 0.89M / 1.30M; m = 15..17 at B = 4096 /
# 16384 600.0k / 803.1k, 292.5k / 379.1k, 142.1k / 178.3k against 459.5k /
# 619.8k, 239.7k / 294.4k, 116.7k / 140.6k).
AUTO_BIG_BATCH = 16384
AUTO_STEP_PATH = {
    **{(m, s): ("fused", "fused") for m in range(2, 12) for s in (True, False)},
    **{(m, True): ("fused", "front") for m in (8, 9, 10)},
    **{(m, False): ("fused", "draws") for m in (10, 11)},
    (11, True): ("front", "front"), (12, True): ("front", "front"),
    (12, False): ("draws", "draws"),
    **{(m, True): ("front", "front") for m in (13, 14, 15, 16)},
    **{(m, False): ("draws", "draws") for m in range(13, 18)}}

# The front path's branches (polar_tpu/ber.py:193-279), by level; the JAX
# package's thresholds are VMEM facts about the TPU. Systematic codes at
# m <= FRONT_WHOLE_MAX_LEVEL take the whole-block front + decode+count, the
# best front at m = 6..9 in the same A/B (frames/s at B = 4096 / 32768;
# m = 9: 4.56M / 24.3M against block + whole-code 4.35M / 23.0M) until the
# tile kernel took m = 9 (block + whole-code 6.84M / 35.33M against 4.49M /
# 24.18M); above it the whole front's per-thread transforms slowed down
# (11.0 ms at m = 12 against the block front's 1.15 ms, B = 4096; the
# row-word whole front reads 0.12 ms there). Every other code takes the
# block front, then the whole-code decoder below
# decode.auto.HYBRID_MIN_LEVEL and the hybrid from it (the best front arm
# at every level, both modes: m = 10 systematic 1.98M / 6.53M against
# 1.91M / 5.79M, plain 1.58M / 6.85M against 1.49M / 6.34M), with
# the counter kernel when systematic (2.26 ms against its plain version's
# 19.2 ms at Polar(131072, 65536), B = 4096). With the tile kernel as the
# whole-code decoder (HYBRID_MIN_LEVEL 14) block-whole is the front below
# m = 14 (systematic m = 13, B = 4096: 673.1k against block-hybrid's
# 361.0k). The block front + decode+count won at no level (m = 10: 1.72M /
# 5.12M), so no branch runs it. Systematic codes take the
# block front + the interpreter's decode+count ("block-interp", JAX's
# _INTERP_COUNT_LEVELS branch) where decode.auto's table names the
# interpreter on the codeword track at every batch (m = 13..17): with its
# tile kernel (one cooperative launch for the whole decode) it beat
# block-whole at m = 13 (2.087M / 3.138M against 1.064M / 1.081M frames/s
# at B = 4096 / 32768) and block-hybrid at m = 14..17 (m = 14 1.024M /
# 1.465M against 351.1k / 581.0k; m = 17 118.4k against 39.3k; at
# B = 16384 177.9k against 52.8k), see AUTO_STEP_PATH; m >= 18 was not
# measured with it. With the row-word whole front and the tile
# decode+count (PERF.md) the whole branch led the other front
# branches at m = 9, 10 at both batches (m = 9: 19.14M / 96.06M against
# block-whole's 17.30M / 74.46M; m = 10: 14.20M / 36.67M against 9.68M /
# 33.56M) and at m = 11 below AUTO_BIG_BATCH (11.34M against 10.71M), tied
# with block-whole from it (11.91M against 11.93M), and trailed block-whole
# at m = 12 (3.36M / 3.40M against 3.66M / 3.76M), so the threshold moved
# from 8 to 11 (step_ab --levels 6-13, systematic; same card).
FRONT_WHOLE_MAX_LEVEL = 11
FRONT_BRANCHES = ("whole", "block-whole", "block-hybrid", "block-interp")
SYSTEMATIC_BRANCHES = ("whole", "block-interp")
# steps run, by the path that ran them (_step_path's names): one increment a
# step call, whether or not a profiler session runs ("draws": the kernel
# draws around a decoder, their plain versions on the CPU; "plain": the
# torch draws)
STEP_PATHS = ("draws", "plain", "front", "fused")
steps_by_path = dict.fromkeys(STEP_PATHS, 0)


@dataclass
class SnrPoint:
    snr_db: float
    ebn0_db: float
    frames: int
    bit_errors: int
    ber: float
    fer: float
    awgn_errors: int
    quantization_erasures: int
    ambiguity_erasures: int
    info_bits_per_sec: float  # decode-only throughput, info bits/s


@dataclass
class CampaignResult:
    code_n: int
    code_k: int
    systematic: bool
    points: list = field(default_factory=list)
    qef_snr_db: float = math.inf  # lowest SNR of the error-free tail
    peak_mbps: float = 0.0        # peak decode throughput, info Mbit/s
    seed: int | None = None       # PRNG seed (checkpoint-resume guard)

    def table(self) -> str:
        """4-column table matching ``testbench.cc:218`` (SNR BER Mbit/s Eb/N0)."""
        return "\n".join(
            f"{p.snr_db:.1f} {p.ber:g} {p.info_bits_per_sec / 1e6:.1f} {p.ebn0_db:g}"
            for p in self.points
        )


def _seed(gen: torch.Generator) -> int:
    """One 63-bit seed drawn from a host generator."""
    return int(torch.randint(0, 2**63 - 1, (), generator=gen))


def _device_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``gen``."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(gen))
    return g


def _philox_seeds(gen: torch.Generator) -> tuple[int, int]:
    """Two 32-bit Philox seed words drawn from a host generator (the span
    ``step.seeds``)."""
    with annotate("step.seeds"):
        return tuple(int(s) for s in torch.randint(
            0, 2**32, (2,), generator=gen, dtype=torch.int64))


def _default_decoder(code: PolarCode, systematic: bool, dtype, compute,
                     device):
    """The device's best decoder for int8 with no compute override, else
    the eager decoder in the requested compute mode."""
    out = "systematic" if systematic else "u"
    if compute is None and dtype == torch.int8:
        return make_auto_decoder(code, output=out, output_dtype=dtype,
                                 device=device)[0]
    return make_fastssc_decoder(code, output=out, compute=compute,
                                output_dtype=dtype)


RNG_MODES = ("torch", "kernel", "kernel-bits")


def make_step_body(code: PolarCode, *, systematic: bool = True,
                   dtype=torch.int8, decoder=None, compute=None,
                   rng: str = "torch", device):
    """The Monte-Carlo chain around a decoder (``polar_tpu/ber.py:384-411``):
    ``step(gen, snr_db, batch)`` → counters. The decoder is ``decoder``,
    else the device's best decoder (int8) or the eager one.

    ``rng`` picks how the message, the encode and the noise are made (the
    JAX package's ``rng``, ``:181-185``, ``:301-321``):

    * ``"torch"`` — ``torch.randint``, the torch encoder and
      ``torch.randn`` on a device generator seeded from ``gen`` (the
      counterpart of ``"threefry"``);
    * ``"kernel"`` — the symbols kernel, the block encoder and the AWGN
      kernel, with native Philox words keyed by two seed pairs drawn from
      ``gen`` per step, one for the message and one for the noise (the
      counterpart of ``"pallas"``); with no pinned decoder (int8, no
      compute override) the step is the element-major front path
      instead, as the JAX package's (:func:`make_front_step`);
    * ``"kernel-bits"`` — the same kernels fed the
      ``words=(message (B, K), radius (B, N), angle (B, N))`` int64
      tensors that the caller passes to every step (the counterpart of
      ``"pallas-bits"``, whose words the JAX package draws from the
      step's key).

    The kernels run on a card and their plain versions on the CPU. Only
    int8 takes them; other dtypes keep the torch draws, as in JAX. The JAX
    package also keeps threefry where a shape does not tile
    (``channel_kernel.py:pick_blocks``, ``batch % 128``); the port's
    kernels take any batch and any N >= 2, so it has no such fallback.

    The step counts itself in :data:`steps_by_path` (``"draws"`` with the
    kernels, else ``"plain"``), and its counters run in the span
    ``step.count``: with the kernel draws one counter kernel
    (``count_kernel.count_frames``, its plain version on the CPU), with
    the torch draws :func:`frame_counters`."""
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode {rng!r}")
    device = torch.device(device)
    if (rng == "kernel" and decoder is None and compute is None
            and dtype == torch.int8):
        return make_front_step(code, systematic=systematic, device=device)
    enc = encode_systematic if systematic else encode
    if decoder is None:
        decoder = _default_decoder(code, systematic, dtype, compute, device)
    kernel_rng = rng != "torch" and dtype == torch.int8
    if kernel_rng:
        kenc = encode_kernel.make_encoder(code, systematic=systematic)

    def draw_torch(gen, snr_db, batch):
        g = _device_generator(gen, device)
        bits = torch.randint(0, 2, (batch, code.K), generator=g, device=device)
        message = (1 - 2 * bits).to(dtype)
        codeword = enc(code, message)
        return message, codeword, awgn_llrs(g, codeword, snr_db, dtype,
                                            device=device)

    def draw_kernels(gen, snr_db, batch, words):
        params = snr_params(snr_db)
        if rng == "kernel":
            message = channel_kernel.symbols((batch, code.K),
                                             seeds=_philox_seeds(gen),
                                             device=device)
            codeword = kenc(message)
            return message, codeword, channel_kernel.awgn(
                codeword, params, seeds=_philox_seeds(gen))
        message = channel_kernel.symbols(words=words[0])
        codeword = kenc(message)
        return message, codeword, channel_kernel.awgn(codeword, params,
                                                      words=words[1:])

    def step(gen, snr_db, batch: int, *, words=None):
        if kernel_rng and rng == "kernel-bits":
            if words is None:
                raise ValueError("rng='kernel-bits' takes its words from the "
                                 "caller: pass words=")
        elif words is not None:
            raise ValueError("words= is taken by int8 rng='kernel-bits' only")
        if kernel_rng:
            steps_by_path["draws"] += 1
            message, codeword, llrs = draw_kernels(gen, snr_db, batch, words)
        else:
            steps_by_path["plain"] += 1
            message, codeword, llrs = draw_torch(gen, snr_db, batch)
        decoded = decoder(llrs)
        with annotate("step.count"):
            if kernel_rng:
                return _unpack(count_kernel.count_frames(message, codeword,
                                                         llrs, decoded))
            return frame_counters(message, codeword, llrs, decoded)

    return step


def frame_counters(message, codeword, llrs, decoded) -> dict:
    """The five counters of frame-major ``(B, K)`` message and decoded bits
    and ``(B, N)`` codeword and LLRs (:func:`count_kernel.u_counters
    <polar_tpu_torch.ops.cuda.count_kernel.u_counters>`, the bool domain of
    ``polar_tpu/ber.py:394-411``), as 0-d int64 tensors."""
    return _unpack(count_kernel.u_counters(message, codeword, llrs, decoded))


def _unpack(t) -> dict:
    """The counter dict of a step's five counters (the span
    ``step.unpack``)."""
    with annotate("step.unpack"):
        return dict(zip(step_kernel.COUNTERS, t))


def step_kernel_eligible(code: PolarCode, dtype, compute) -> bool:
    """Whether the fused step covers this configuration: int8, no compute
    override, level in [STEP_KERNEL_MIN_LEVEL, STEP_KERNEL_MAX_LEVEL]."""
    return (compute is None and dtype == torch.int8
            and STEP_KERNEL_MIN_LEVEL <= code.level <= STEP_KERNEL_MAX_LEVEL)


def _step_path(code: PolarCode, dtype, compute, decoder, fused, device,
               systematic: bool = True, batch: int = 4096) -> str:
    """Which step ``make_step`` runs for steps of ``batch`` frames (by
    default :func:`run_campaign`'s): ``"fused"`` (``fused=True``, or
    ``"auto"`` where :data:`AUTO_STEP_PATH` says so and the fused step
    covers the configuration), ``"front"`` (``"auto"``, int8, no
    override, no pinned decoder, elsewhere), ``"draws"`` (``"auto"``,
    int8, no override, on a CUDA device: the kernel draws around a pinned
    decoder, or around the auto decoder where :data:`AUTO_STEP_PATH` says
    so) or ``"plain"`` (the torch draws; on the CPU the JAX package keeps
    threefry too, ``polar_tpu/ber.py:501-504``)."""
    auto_int8 = fused == "auto" and compute is None and dtype == torch.int8
    want = AUTO_STEP_PATH.get((code.level, systematic),
                              ("front", "front"))[batch >= AUTO_BIG_BATCH]
    if fused is True or (auto_int8 and decoder is None and want == "fused"
                         and step_kernel_eligible(code, dtype, compute)):
        return "fused"
    if auto_int8 and decoder is None and want != "draws":
        return "front"
    if auto_int8 and torch.device(device).type == "cuda":
        return "draws"
    return "plain"


def front_branch(code: PolarCode, systematic: bool) -> str:
    """The front path's branch for this code (``polar_tpu/ber.py:193-279``):
    ``"whole"`` (systematic: the whole-block front, decode+count),
    ``"block-whole"`` (the block front, the whole-code kernel decoder's
    lane-major entry, the counter kernel or torch u-domain counters) or
    ``"block-hybrid"`` (the same with the hybrid decoder); the choice of
    decoder is :mod:`~polar_tpu_torch.decode.auto`'s, and so is
    ``"block-interp"`` (systematic: the block front, the interpreter
    decode+count), where its table names the interpreter on the codeword
    track at every batch."""
    if systematic and code.level <= FRONT_WHOLE_MAX_LEVEL:
        return "whole"
    if systematic and decode_auto.decoder_names(code.level, True) == (
            "interp", "interp"):
        return "block-interp"
    return ("block-hybrid" if code.level >= decode_auto.HYBRID_MIN_LEVEL
            else "block-whole")


def make_front_chain(code: PolarCode, *, systematic: bool = True,
                     branch: str | None = None,
                     kernel_level: int | None = None,
                     kernel_style: str | None = None,
                     middle_mode: str = "kernel"):
    """The front path's chain (``polar_tpu/ber.py:323-359``):
    ``chain(params, **draw)`` → the five counters as a ``(5,)`` int64
    tensor in ``step_kernel.COUNTERS`` order.

    ``params`` = (σ, 2/σ²); ``draw`` is the front's: ``msg_t`` and
    ``normals_t`` (inject) or ``seeds``, ``call``, ``batch`` and
    ``device`` (native, the fused step's Philox words, so every branch
    counts what the fused step counts on the same seeds). ``branch`` is
    :func:`front_branch`'s unless given (one of :data:`FRONT_BRANCHES`;
    :data:`SYSTEMATIC_BRANCHES` are systematic only). Systematic
    decoders emit the codeword estimate, counted against the codeword in
    the cw domain; plain ones the u estimate, counted against the block
    front's ``u0`` in torch (XLA in the JAX package). ``kernel_level`` is
    the hybrid's (by default
    :func:`~polar_tpu_torch.decode.auto.hybrid_kernel_level`'s) and
    implies the ``"block-hybrid"`` branch. The decoder of ``"block-whole"``
    and ``"block-hybrid"`` takes its kernel style from
    :func:`~polar_tpu_torch.decode.auto.kernel_style` by each call's batch,
    or ``kernel_style`` when given. ``middle_mode`` goes to the block
    front."""
    if branch is None:
        branch = ("block-hybrid" if kernel_level is not None
                  else front_branch(code, systematic))
    if branch not in FRONT_BRANCHES or (
            not systematic and branch in SYSTEMATIC_BRANCHES):
        raise ValueError(f"no front branch {branch!r} for "
                         f"systematic={systematic}")
    if kernel_level is not None and branch != "block-hybrid":
        raise ValueError(f"kernel_level is the hybrid's; branch {branch!r} "
                         "has none")
    if kernel_style is not None and branch not in ("block-whole",
                                                   "block-hybrid"):
        raise ValueError(f"branch {branch!r} has no kernel_style")
    frozen = code.frozen

    def front(params, draw):
        if branch == "whole":
            return step_kernel.front(frozen, params, **draw)
        return front_kernel.front_blocks(frozen, params, systematic,
                                         middle_mode=middle_mode, **draw)

    if branch in SYSTEMATIC_BRANCHES:
        if branch == "block-interp":
            decode_count = interp_kernel.make_interp_decode_count(code)
        else:
            program = compile_program(code)

            def decode_count(llr_t, cw_t):
                return step_kernel.decode_count(program, frozen, llr_t, cw_t)

        def count_chain(params, **draw):
            return decode_count(*front(params, draw))

        return count_chain
    out = "codeword" if systematic else "u"
    hybrid = branch == "block-hybrid"
    kl = hybrid_kernel_level(code.level) if kernel_level is None else kernel_level
    decoders = {}

    def dec(llr_t):
        style = kernel_style or decode_auto.kernel_style(
            code.level, systematic, llr_t.shape[1], hybrid)
        if style not in decoders:
            decoders[style] = (make_fastssc_decoder(
                code, output=out, output_dtype=torch.int8, kernel_level=kl,
                kernel_style=style) if hybrid else make_kernel_decoder(
                    code, output=out, style=style)).lane_major
        return decoders[style](llr_t)

    def chain(params, **draw):
        outs = front(params, draw)
        if systematic:
            llr_t, cw_t = outs
            return count_kernel.count(frozen, llr_t, cw_t, dec(llr_t))
        llr_t, cw_t, u0_t = outs
        hat = dec(llr_t)
        msg = u0_t[torch.as_tensor(code.info_indices, device=u0_t.device)]
        zero_d = hat == 0
        err = zero_d | ((hat < 0) != (msg < 0))
        awgn = (llr_t != 0) & ((llr_t < 0) != (cw_t < 0))
        return torch.stack([err.sum(), err.any(dim=0).sum(), zero_d.sum(),
                            awgn.sum(), (llr_t == 0).sum()]).to(torch.int64)

    return chain


def make_front_step(code: PolarCode, *, systematic: bool = True,
                    device, **chain_kw):
    """The front path as a step: ``step(gen, snr_db, batch)`` → the
    counter dict, over :func:`make_front_chain` (``chain_kw``: its
    ``branch``, ``kernel_level``, ``kernel_style``, ``middle_mode``) with
    native Philox
    words, seeds drawn fresh from ``gen`` on every call (call word 0),
    the fused step's words."""
    chain = make_front_chain(code, systematic=systematic, **chain_kw)

    def front_step(gen, snr_db, batch: int, *, words=None):
        if words is not None:
            raise ValueError("words= is taken by int8 rng='kernel-bits' only")
        steps_by_path["front"] += 1
        t = chain(snr_params(snr_db), seeds=_philox_seeds(gen), call=0,
                  batch=batch, device=device)
        return _unpack(t)

    return front_step


def make_step(code: PolarCode, *, systematic: bool = True, dtype=torch.int8,
              decoder=None, compute=None, fused: str | bool = "auto",
              front_decode_cfg: int | None = None, step_style: str = "ssa",
              device):
    """Build the Monte-Carlo step: ``step(gen, snr_db, batch)`` → the
    counter dict (0-d int64 tensors on ``device``).

    ``fused``: ``"auto"`` runs, for int8 codes without a pinned decoder,
    the fused step, the front path or the kernel draws around the auto
    decoder, as :data:`AUTO_STEP_PATH` says for the level, the mode and
    the batch of each call (on the CPU the torch draws in place of the
    kernel draws); with a pinned
    int8 ``decoder`` on a CUDA device it runs the kernel draws
    (:func:`make_step_body` with ``rng="kernel"``) around that decoder.
    ``True`` requires the fused step; ``False`` runs the plain chain with
    the torch draws. The kernel steps draw fresh Philox seed words from
    ``gen`` on every call, so their call word stays 0 and each step is a
    pure function of ``gen``'s state (a resumed campaign repeats an
    uninterrupted one); the front path draws the fused step's words, so
    both count alike on the same seeds.

    ``front_decode_cfg``: the front path's hybrid kernel level, in place
    of the default (``polar_tpu/ber.py:167-176``); a measurement hook.
    It raises ``ValueError`` when the configuration does not take the
    front path's hybrid branch at every batch, where it would be
    ignored.

    ``step_style``: the fused step's kernel style
    (``step_kernel.STEP_STYLES``: ``"ssa"``, the tile step where it fits,
    or ``"walk"``); a measurement hook for the step A/B."""
    if step_style not in step_kernel.STEP_STYLES:
        raise ValueError(f"unknown step style {step_style!r}")
    if fused is True and not step_kernel_eligible(code, dtype, compute):
        raise ValueError(
            f"fused step supports int8 codes (no compute override) at levels "
            f"{STEP_KERNEL_MIN_LEVEL}..{STEP_KERNEL_MAX_LEVEL} only (got "
            f"N={code.N}, dtype={dtype}, compute={compute!r})")
    # the path below AUTO_BIG_BATCH frames a step, and from it on
    paths = [_step_path(code, dtype, compute, decoder, fused, device,
                        systematic, batch) for batch in (1, AUTO_BIG_BATCH)]
    for path in paths:
        if front_decode_cfg is not None and (
                path != "front"
                or front_branch(code, systematic) != "block-hybrid"):
            where = (f"the {front_branch(code, systematic)} branch of the "
                     "front path" if path == "front" else f"the {path} step")
            raise ValueError(
                f"front_decode_cfg was passed but N={code.N} takes {where}, "
                "not the front path's hybrid decoder: the override would be "
                "ignored")
    steps = {path: _path_step(code, path, systematic=systematic, dtype=dtype,
                              decoder=decoder, compute=compute,
                              kernel_level=front_decode_cfg,
                              step_style=step_style, device=device)
             for path in set(paths)}
    if len(steps) == 1:
        return steps[paths[0]]

    def by_batch(gen, snr_db, batch: int):
        return steps[paths[batch >= AUTO_BIG_BATCH]](gen, snr_db, batch)

    return by_batch


def _path_step(code: PolarCode, path: str, *, systematic: bool, dtype,
               decoder, compute, kernel_level, step_style, device):
    """:func:`make_step`'s step on one of :func:`_step_path`'s paths."""
    if path == "draws" and decoder is None:
        decoder = _default_decoder(code, systematic, dtype, compute, device)
    if path in ("plain", "draws"):
        return make_step_body(code, systematic=systematic, dtype=dtype,
                              decoder=decoder, compute=compute,
                              rng="kernel" if path == "draws" else "torch",
                              device=device)
    if path == "front":
        return make_front_step(code, systematic=systematic,
                               kernel_level=kernel_level, device=device)
    program = compile_program(code)

    def fused_step(gen, snr_db, batch: int):
        steps_by_path["fused"] += 1
        t = step_kernel.step(program, code.frozen, snr_params(snr_db),
                             systematic, seeds=_philox_seeds(gen), call=0,
                             batch=batch, device=device, style=step_style)
        return _unpack(t)

    return fused_step


def chain_steps(step):
    """``multi(gen, snr_db, batch, steps)``: ``steps`` calls of ``step``,
    each drawing its seeds from ``gen`` in turn, with the counters summed
    on the device (int64) and nothing pulled to the host."""

    def multi(gen, snr_db, batch: int, steps: int):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        acc = None
        for _ in range(steps):
            out = step(gen, snr_db, batch)
            t = torch.stack([out[name] for name in step_kernel.COUNTERS])
            acc = t if acc is None else acc + t
        return _unpack(acc)

    return multi


def make_multi_step(code: PolarCode, *, systematic: bool = True,
                    dtype=torch.int8, decoder=None, compute=None,
                    fused: str | bool = "auto",
                    front_decode_cfg: int | None = None, device):
    """Build ``multi(gen, snr_db, batch, steps)`` (``polar_tpu/ber.py:533-567``):
    ``steps`` Monte-Carlo steps of :func:`make_step` (same arguments),
    chained by :func:`chain_steps`, for one host pull per call in
    :func:`run_point`. Each inner step draws its seeds from ``gen``, so a
    chained run equals the same steps called one by one, and a resumed
    campaign repeats an uninterrupted one. The counters are int64, so the
    JAX package's int32 overflow assert (``steps * batch * N < 2^31``,
    ``:552``) has no counterpart."""
    return chain_steps(make_step(
        code, systematic=systematic, dtype=dtype, decoder=decoder,
        compute=compute, fused=fused, front_decode_cfg=front_decode_cfg,
        device=device))


def run_point(
    code: PolarCode,
    snr_db: float,
    *,
    gen: torch.Generator,
    step=None,
    systematic: bool = True,
    dtype=torch.int8,
    batch: int = 4096,
    max_frames: int = 1 << 16,
    target_bit_errors: int = 1000,
    decode_fn=None,
    measure_throughput: bool = False,
    steps_per_call: int = 1,
    device,
) -> SnrPoint:
    """Measure one SNR point, stopping once enough errors are seen
    (``testbench.cc:125``: errors >= 1000 or the frame budget is hit).
    ``gen`` is a host generator; each step draws from it.

    ``steps_per_call`` > 1 runs that many steps per call (``step`` must
    then be a :func:`make_multi_step` callable); the counters come to the
    host once per call, and the early-stop check runs at that
    granularity.

    Spans (:func:`~polar_tpu_torch.utils.profiling.annotate`):
    ``run_point`` over the point, ``run_point.step`` over each step call
    and ``run_point.pull`` over each pull, the host's wait included."""
    with annotate("run_point"):
        if step is None:
            make = make_multi_step if steps_per_call > 1 else make_step
            step = make(code, systematic=systematic, dtype=dtype,
                        device=device)
        totals = dict.fromkeys(step_kernel.COUNTERS, 0)
        frames = 0
        while (frames < max_frames
               and totals["uncorrected_errors"] < target_bit_errors):
            with annotate("run_point.step"):
                if steps_per_call > 1:
                    out = step(gen, snr_db, batch, steps_per_call)
                else:
                    out = step(gen, snr_db, batch)
            frames += batch * steps_per_call if steps_per_call > 1 else batch
            # one host pull per call; a caller's step may return Python ints
            with annotate("run_point.pull"):
                pulled = torch.stack([torch.as_tensor(out[name])
                                      for name in step_kernel.COUNTERS])
                values = pulled.tolist()
            for name, v in zip(step_kernel.COUNTERS, values):
                totals[name] += v

        bps = 0.0
        if measure_throughput and decode_fn is not None:
            bps = measure_decode_throughput(code, decode_fn, snr_db, gen,
                                            batch, dtype, device=device)
    bits = frames * code.K
    return SnrPoint(
        snr_db=snr_db,
        ebn0_db=ebn0_db(snr_db, code.rate),
        frames=frames,
        bit_errors=totals["uncorrected_errors"],
        ber=totals["uncorrected_errors"] / bits,
        fer=totals["frame_errors"] / frames,
        awgn_errors=totals["awgn_errors"],
        quantization_erasures=totals["quantization_erasures"],
        ambiguity_erasures=totals["ambiguity_erasures"],
        info_bits_per_sec=bps,
    )


def measure_decode_throughput(code, decode_fn, snr_db, gen, batch, dtype, *,
                              device, iters: int = 32,
                              repeats: int = 3) -> float:
    """Decode-only throughput in info bits/s, the analog of the timed
    region at ``testbench.cc:170-174``, by the chained slope method
    (:func:`polar_tpu_torch.utils.benchmark.measure_decode_fps`) on
    ``device``'s clock. ``repeats`` stays >= 2 so the cross-repeat slope
    consistency check is live."""
    g = _device_generator(gen, device)
    bits = torch.randint(0, 2, (batch, code.K), generator=g, device=device)
    message = (1 - 2 * bits).to(dtype)
    llrs = awgn_llrs(g, encode(code, message), snr_db, dtype, device=device)
    return measure_decode_fps(decode_fn, llrs, iters=iters,
                              repeats=repeats) * code.K


def run_campaign(
    code: PolarCode,
    *,
    seed: int = 0,
    systematic: bool = True,
    dtype=torch.int8,
    batch: int = 4096,
    max_frames_per_point: int = 1 << 16,
    target_bit_errors: int = 1000,
    snr_range: tuple | None = None,
    snr_step: float = 0.1,
    stop_after_clean: int = 4,
    measure_throughput: bool = True,
    verbose: bool = False,
    compute=None,
    checkpoint_path=None,
    decoder=None,
    steps_per_call: int = 1,
    fused: str | bool = "auto",
    front_decode_cfg: int | None = None,
    device,
) -> CampaignResult:
    """Full waterfall sweep with the reference's early-stop rule: finish
    after ``stop_after_clean`` consecutive error-free points
    (``testbench.cc:110,198-201``).

    With ``checkpoint_path``, the result JSON is rewritten after every SNR
    point and previously-completed points are reloaded on restart; each
    point's generator is seeded from the campaign seed in point order, so
    a resumed campaign is identical to an uninterrupted one.

    The steps run the fused step, the front path or the kernel draws
    where :func:`make_step` picks them; a passed-in ``decoder`` is kept,
    with the kernel draws on a card (``front_decode_cfg`` goes to
    :func:`make_step`). ``steps_per_call`` > 1 chains that many steps per
    host pull (:func:`make_multi_step`). The decoder serves the
    decode-only throughput gauge too, measured once per campaign.
    """
    device = torch.device(device)
    design = design_snr_db(1.0 - code.rate)
    if snr_range is None:
        snr_range = (math.floor(design - 3), math.ceil(design + 5))
    kernel_step = _step_path(code, dtype, compute, decoder, fused, device,
                             systematic, batch) in ("fused", "front")
    if decoder is None and (measure_throughput or not kernel_step):
        decoder = _default_decoder(code, systematic, dtype, compute, device)
    make = make_multi_step if steps_per_call > 1 else make_step
    step = make(code, systematic=systematic, dtype=dtype, compute=compute,
                decoder=None if kernel_step else decoder, fused=fused,
                front_decode_cfg=front_decode_cfg, device=device)
    gen = torch.Generator()
    gen.manual_seed(seed)
    result = CampaignResult(code_n=code.N, code_k=code.K,
                            systematic=systematic, seed=seed)
    done: dict = {}
    if checkpoint_path is not None:
        from .campaign_io import load_result, save_result

        prev = load_result(checkpoint_path)
        if (prev is not None
                and (prev.code_n, prev.code_k) == (code.N, code.K)
                and prev.systematic == systematic
                and prev.seed in (None, seed)):
            done = {round(p.snr_db, 6): p for p in prev.points}
    clean = 0
    snr = snr_range[0]
    bps = None  # decode-only gauge, measured once per campaign
    while snr <= snr_range[1] + 1e-9 and clean < stop_after_clean:
        point_gen = torch.Generator()
        point_gen.manual_seed(_seed(gen))
        snr_r = round(snr, 6)
        if snr_r in done:
            point = done[snr_r]
        else:
            point = run_point(
                code, snr_r, gen=point_gen, step=step, systematic=systematic,
                dtype=dtype, batch=batch, max_frames=max_frames_per_point,
                target_bit_errors=target_bit_errors,
                steps_per_call=steps_per_call, device=device)
            if measure_throughput:
                # the decode has no data-dependent cost, so the per-point
                # Mb/s of the reference's table is one number: measure it
                # once and stamp it on every computed point
                if bps is None:
                    bps = measure_decode_throughput(
                        code, decoder, snr_r, point_gen, batch, dtype,
                        device=device)
                point.info_bits_per_sec = bps
        result.points.append(point)
        result.peak_mbps = max(result.peak_mbps, point.info_bits_per_sec / 1e6)
        if point.bit_errors == 0:
            result.qef_snr_db = min(result.qef_snr_db, point.snr_db)
            clean += 1
        else:
            clean = 0
            result.qef_snr_db = math.inf
        if verbose:
            print(
                f"{point.snr_db:.1f} {point.ber:g} "
                f"{point.info_bits_per_sec / 1e6:.1f} {point.ebn0_db:g}",
                flush=True,
            )
        if checkpoint_path is not None:
            save_result(result, checkpoint_path)
        snr += snr_step
    return result
