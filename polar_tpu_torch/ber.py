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

One step runs a whole frame batch. int8 codes at levels 2 ..
``STEP_KERNEL_MAX_LEVEL`` go through the fused step
(:mod:`polar_tpu_torch.ops.cuda.step_kernel`); int8 codes above it
through the large-N front path (``polar_tpu/ber.py:193-359``): the block
front (:mod:`~polar_tpu_torch.ops.cuda.front_kernel`), the hybrid
decoder's element-major entry and, when systematic, the counter kernel
(:mod:`~polar_tpu_torch.ops.cuda.count_kernel`). Each runs its CUDA
kernels on a card and their plain versions on the CPU. A decoder pinned
by the caller keeps the chain of :func:`make_step_body` around it: on a
card its message, encode and noise come from the symbols, block-encoder
and AWGN kernels (:mod:`~polar_tpu_torch.ops.cuda.channel_kernel`,
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
from .decode.auto import hybrid_kernel_level, make_auto_decoder
from .decode.fastssc import make_fastssc_decoder
from .encode import encode, encode_systematic
from .ops.cuda import (channel_kernel, count_kernel, encode_kernel,
                       front_kernel, step_kernel)
from .utils.benchmark import measure_decode_fps

# Levels at which make_step runs the fused step kernel for int8 codes. The
# kernel keeps every frame's columns in device memory, so no level is
# excluded by on-chip memory; the ceiling is the largest level checked on
# the card against the plain chain (chip_smoke.py, phase 3).
STEP_KERNEL_MIN_LEVEL = 2
STEP_KERNEL_MAX_LEVEL = 16


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
    """Two 32-bit Philox seed words drawn from a host generator."""
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
      counterpart of ``"pallas"``);
    * ``"kernel-bits"`` — the same kernels fed the
      ``words=(message (B, K), radius (B, N), angle (B, N))`` int64
      tensors that the caller passes to every step (the counterpart of
      ``"pallas-bits"``, whose words the JAX package draws from the
      step's key).

    The kernels run on a card and their plain versions on the CPU. Only
    int8 takes them; other dtypes keep the torch draws, as in JAX. The JAX
    package also keeps threefry where a shape does not tile
    (``channel_kernel.py:pick_blocks``, ``batch % 128``); the port's
    kernels take any batch and any N >= 2, so it has no such fallback."""
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode {rng!r}")
    device = torch.device(device)
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
            message, codeword, llrs = draw_kernels(gen, snr_db, batch, words)
        else:
            message, codeword, llrs = draw_torch(gen, snr_db, batch)
        return frame_counters(message, codeword, llrs, decoder(llrs))

    return step


def frame_counters(message, codeword, llrs, decoded) -> dict:
    """The five counters of frame-major ``(B, K)`` message and decoded bits
    and ``(B, N)`` codeword and LLRs, as 0-d int64 tensors in the bool
    domain (``polar_tpu/ber.py:394-411``): for message/codeword in {-1,+1},
    ``decoded*message <= 0`` ⟺ ``decoded==0 ∨ sign(decoded)≠sign(message)``
    and ``llrs*codeword < 0`` ⟺ ``llrs≠0 ∧ sign(llrs)≠sign(codeword)``."""
    zero_d = decoded == 0
    errs = zero_d | ((decoded < 0) != (message < 0))
    return dict(zip(step_kernel.COUNTERS, (
        errs.sum(), errs.any(dim=-1).sum(), zero_d.sum(),
        ((llrs != 0) & ((llrs < 0) != (codeword < 0))).sum(),
        (llrs == 0).sum())))


def step_kernel_eligible(code: PolarCode, dtype, compute) -> bool:
    """Whether the fused step covers this configuration: int8, no compute
    override, level in [STEP_KERNEL_MIN_LEVEL, STEP_KERNEL_MAX_LEVEL]."""
    return (compute is None and dtype == torch.int8
            and STEP_KERNEL_MIN_LEVEL <= code.level <= STEP_KERNEL_MAX_LEVEL)


def _step_path(code: PolarCode, dtype, compute, decoder, fused,
               device) -> str:
    """Which step ``make_step`` runs: ``"fused"`` (``fused=True``, or
    ``"auto"`` for eligible configurations without a pinned ``decoder``),
    ``"front"`` (``"auto"``, int8, no override, no pinned decoder, above
    ``STEP_KERNEL_MAX_LEVEL``), ``"draws"`` (``"auto"``, int8, no
    override, a pinned decoder, a CUDA device: the kernel draws around
    the caller's decoder) or ``"plain"`` (the torch draws; on the CPU the
    JAX package keeps threefry too, ``polar_tpu/ber.py:501-504``)."""
    auto_int8 = fused == "auto" and compute is None and dtype == torch.int8
    if fused is True or (auto_int8 and decoder is None
                         and step_kernel_eligible(code, dtype, compute)):
        return "fused"
    if auto_int8 and decoder is None and code.level > STEP_KERNEL_MAX_LEVEL:
        return "front"
    if auto_int8 and decoder is not None and torch.device(device).type == "cuda":
        return "draws"
    return "plain"


def make_front_chain(code: PolarCode, *, systematic: bool = True,
                     kernel_level: int | None = None):
    """The large-N step's chain (``polar_tpu/ber.py:323-359``):
    ``chain(params, **draw)`` → the five counters as a ``(5,)`` int64
    tensor in ``step_kernel.COUNTERS`` order.

    ``params`` = (σ, 2/σ²); ``draw`` is the front's: ``msg_t`` and
    ``normals_t`` (inject) or ``seeds``, ``call``, ``batch`` and
    ``device`` (native, the fused step's Philox words). Systematic: the
    block front, the hybrid's codeword output, the counter kernel (cw
    domain). Plain: the block front with ``u0``, the hybrid's u output,
    u-domain counters in torch (XLA in the JAX package). ``kernel_level``
    is the hybrid's, by default
    :func:`~polar_tpu_torch.decode.auto.hybrid_kernel_level`'s."""
    if kernel_level is None:
        kernel_level = hybrid_kernel_level(code.level)
    dec = make_fastssc_decoder(
        code, output="codeword" if systematic else "u",
        output_dtype=torch.int8, kernel_level=kernel_level).lane_major
    frozen = code.frozen

    def chain(params, **draw):
        outs = front_kernel.front_blocks(frozen, params, systematic, **draw)
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


def make_step(code: PolarCode, *, systematic: bool = True, dtype=torch.int8,
              decoder=None, compute=None, fused: str | bool = "auto",
              front_decode_cfg: int | None = None, device):
    """Build the Monte-Carlo step: ``step(gen, snr_db, batch)`` → the
    counter dict (0-d int64 tensors on ``device``).

    ``fused``: ``"auto"`` runs the fused step for eligible configurations
    (see :func:`step_kernel_eligible`) and the large-N front path for
    int8 codes above them; with a pinned int8 ``decoder`` on a CUDA device
    it runs the kernel draws (:func:`make_step_body` with ``rng="kernel"``)
    around that decoder. ``True`` requires the fused step; ``False`` runs
    the plain chain with the torch draws. The kernel steps draw fresh
    Philox seed words from ``gen`` on every call, so their call word stays
    0 and each step is a pure function of ``gen``'s state (a resumed
    campaign repeats an uninterrupted one); the front path draws the fused
    step's words, so both count alike on the same seeds.

    ``front_decode_cfg``: the front path's hybrid kernel level, in place
    of the default (``polar_tpu/ber.py:167-176``); a measurement hook.
    It raises ``ValueError`` when the configuration does not take the
    front path, where it would be ignored."""
    if fused is True and not step_kernel_eligible(code, dtype, compute):
        raise ValueError(
            f"fused step supports int8 codes (no compute override) at levels "
            f"{STEP_KERNEL_MIN_LEVEL}..{STEP_KERNEL_MAX_LEVEL} only (got "
            f"N={code.N}, dtype={dtype}, compute={compute!r})")
    path = _step_path(code, dtype, compute, decoder, fused, device)
    if front_decode_cfg is not None and path != "front":
        raise ValueError(
            f"front_decode_cfg was passed but N={code.N} takes the {path} "
            "step, not the large-N front path: the override would be "
            "ignored")
    if path in ("plain", "draws"):
        return make_step_body(code, systematic=systematic, dtype=dtype,
                              decoder=decoder, compute=compute,
                              rng="kernel" if path == "draws" else "torch",
                              device=device)
    if path == "front":
        chain = make_front_chain(code, systematic=systematic,
                                 kernel_level=front_decode_cfg)

        def front_step(gen, snr_db, batch: int):
            t = chain(snr_params(snr_db), seeds=_philox_seeds(gen), call=0,
                      batch=batch, device=device)
            return dict(zip(step_kernel.COUNTERS, t))

        return front_step
    program = compile_program(code)

    def fused_step(gen, snr_db, batch: int):
        t = step_kernel.step(program, code.frozen, snr_params(snr_db),
                             systematic, seeds=_philox_seeds(gen), call=0,
                             batch=batch, device=device)
        return dict(zip(step_kernel.COUNTERS, t))

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
        return dict(zip(step_kernel.COUNTERS, acc))

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
    granularity."""
    if step is None:
        make = make_multi_step if steps_per_call > 1 else make_step
        step = make(code, systematic=systematic, dtype=dtype, device=device)
    totals = dict.fromkeys(step_kernel.COUNTERS, 0)
    frames = 0
    while frames < max_frames and totals["uncorrected_errors"] < target_bit_errors:
        if steps_per_call > 1:
            out = step(gen, snr_db, batch, steps_per_call)
            frames += batch * steps_per_call
        else:
            out = step(gen, snr_db, batch)
            frames += batch
        # one host pull per call; a caller's step may return Python ints
        pulled = torch.stack([torch.as_tensor(out[name])
                              for name in step_kernel.COUNTERS])
        for name, v in zip(step_kernel.COUNTERS, pulled.tolist()):
            totals[name] += v

    bps = 0.0
    if measure_throughput and decode_fn is not None:
        bps = measure_decode_throughput(code, decode_fn, snr_db, gen, batch,
                                        dtype, device=device)
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

    The steps run the fused step or the large-N front path where
    :func:`make_step` picks them; a passed-in ``decoder`` is kept, with
    the kernel draws on a card (``front_decode_cfg`` goes to
    :func:`make_step`). ``steps_per_call`` > 1 chains that many steps per
    host pull (:func:`make_multi_step`). The decoder serves the
    decode-only throughput gauge too, measured once per campaign.
    """
    device = torch.device(device)
    design = design_snr_db(1.0 - code.rate)
    if snr_range is None:
        snr_range = (math.floor(design - 3), math.ceil(design + 5))
    kernel_step = _step_path(code, dtype, compute, decoder, fused,
                             device) in ("fused", "front")
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
