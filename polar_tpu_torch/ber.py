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
kernels on a card and their plain versions on the CPU. Every other
configuration runs the plain chain below with the device's decoder.
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
from .ops.cuda import count_kernel, front_kernel, step_kernel
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


def make_step_body(code: PolarCode, *, systematic: bool = True,
                   dtype=torch.int8, decoder=None, compute=None, device):
    """The plain Monte-Carlo chain (``polar_tpu/ber.py:384-411``):
    ``step(gen, snr_db, batch)`` → counters. Message bits and noise come
    from a device generator seeded from ``gen``; the decoder is
    ``decoder``, else the device's best decoder (int8) or the eager one."""
    device = torch.device(device)
    enc = encode_systematic if systematic else encode
    if decoder is None:
        decoder = _default_decoder(code, systematic, dtype, compute, device)

    def step(gen, snr_db, batch: int):
        g = _device_generator(gen, device)
        bits = torch.randint(0, 2, (batch, code.K), generator=g, device=device)
        message = (1 - 2 * bits).to(dtype)
        codeword = enc(code, message)
        llrs = awgn_llrs(g, codeword, snr_db, dtype, device=device)
        decoded = decoder(llrs)
        # bool-domain counters: for message/codeword in {-1,+1},
        #   decoded*message <= 0  ⟺  decoded==0 ∨ sign(decoded)≠sign(message)
        #   llrs*codeword   <  0  ⟺  llrs≠0 ∧ sign(llrs)≠sign(codeword)
        zero_d = decoded == 0
        errs = zero_d | ((decoded < 0) != (message < 0))
        return dict(zip(step_kernel.COUNTERS, (
            errs.sum(), errs.any(dim=-1).sum(), zero_d.sum(),
            ((llrs != 0) & ((llrs < 0) != (codeword < 0))).sum(),
            (llrs == 0).sum())))

    return step


def step_kernel_eligible(code: PolarCode, dtype, compute) -> bool:
    """Whether the fused step covers this configuration: int8, no compute
    override, level in [STEP_KERNEL_MIN_LEVEL, STEP_KERNEL_MAX_LEVEL]."""
    return (compute is None and dtype == torch.int8
            and STEP_KERNEL_MIN_LEVEL <= code.level <= STEP_KERNEL_MAX_LEVEL)


def _step_path(code: PolarCode, dtype, compute, decoder, fused) -> str:
    """Which step ``make_step`` runs: ``"fused"`` (``fused=True``, or
    ``"auto"`` for eligible configurations without a pinned ``decoder``),
    ``"front"`` (``"auto"``, int8, no override, no pinned decoder, above
    ``STEP_KERNEL_MAX_LEVEL``) or ``"plain"``."""
    if fused is True or (fused == "auto" and decoder is None
                         and step_kernel_eligible(code, dtype, compute)):
        return "fused"
    if (fused == "auto" and decoder is None and compute is None
            and dtype == torch.int8 and code.level > STEP_KERNEL_MAX_LEVEL):
        return "front"
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
    int8 codes above them, unless a ``decoder`` is pinned; ``True``
    requires the fused step; ``False`` runs the plain chain. The kernel
    steps draw two fresh Philox seed words from ``gen`` on every call, so
    their call word stays 0 and each step is a pure function of ``gen``'s
    state (a resumed campaign repeats an uninterrupted one); the front
    path draws the fused step's words, so both count alike on the same
    seeds.

    ``front_decode_cfg``: the front path's hybrid kernel level, in place
    of the default (``polar_tpu/ber.py:167-176``); a measurement hook.
    It raises ``ValueError`` when the configuration does not take the
    front path, where it would be ignored."""
    if fused is True and not step_kernel_eligible(code, dtype, compute):
        raise ValueError(
            f"fused step supports int8 codes (no compute override) at levels "
            f"{STEP_KERNEL_MIN_LEVEL}..{STEP_KERNEL_MAX_LEVEL} only (got "
            f"N={code.N}, dtype={dtype}, compute={compute!r})")
    path = _step_path(code, dtype, compute, decoder, fused)
    if front_decode_cfg is not None and path != "front":
        raise ValueError(
            f"front_decode_cfg was passed but N={code.N} takes the {path} "
            "step, not the large-N front path: the override would be "
            "ignored")
    if path == "plain":
        return make_step_body(code, systematic=systematic, dtype=dtype,
                              decoder=decoder, compute=compute, device=device)

    def seeds_from(gen):
        return tuple(int(s) for s in torch.randint(
            0, 2**32, (2,), generator=gen, dtype=torch.int64))

    if path == "front":
        chain = make_front_chain(code, systematic=systematic,
                                 kernel_level=front_decode_cfg)

        def front_step(gen, snr_db, batch: int):
            t = chain(snr_params(snr_db), seeds=seeds_from(gen), call=0,
                      batch=batch, device=device)
            return dict(zip(step_kernel.COUNTERS, t))

        return front_step
    program = compile_program(code)

    def fused_step(gen, snr_db, batch: int):
        t = step_kernel.step(program, code.frozen, snr_params(snr_db),
                             systematic, seeds=seeds_from(gen), call=0,
                             batch=batch, device=device)
        return dict(zip(step_kernel.COUNTERS, t))

    return fused_step


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
    device,
) -> SnrPoint:
    """Measure one SNR point, stopping once enough errors are seen
    (``testbench.cc:125``: errors >= 1000 or the frame budget is hit).
    ``gen`` is a host generator; each step draws from it."""
    if step is None:
        step = make_step(code, systematic=systematic, dtype=dtype,
                         device=device)
    totals: dict = {}
    frames = 0
    while frames < max_frames and totals.get("uncorrected_errors", 0) < target_bit_errors:
        out = step(gen, snr_db, batch)
        frames += batch
        for k, v in out.items():
            totals[k] = totals.get(k, 0) + int(v)

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
    :func:`make_step` picks them (a passed-in ``decoder`` pins the plain
    chain; ``front_decode_cfg`` goes to :func:`make_step`); the decoder
    built here serves the decode-only throughput gauge, measured once per
    campaign.
    """
    device = torch.device(device)
    design = design_snr_db(1.0 - code.rate)
    if snr_range is None:
        snr_range = (math.floor(design - 3), math.ceil(design + 5))
    kernel_step = _step_path(code, dtype, compute, decoder, fused) != "plain"
    if decoder is None and (measure_throughput or not kernel_step):
        decoder = _default_decoder(code, systematic, dtype, compute, device)
    step = make_step(code, systematic=systematic, dtype=dtype, compute=compute,
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
                target_bit_errors=target_bit_errors, device=device)
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
