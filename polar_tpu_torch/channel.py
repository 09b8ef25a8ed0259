"""AWGN channel, BPSK demodulation and LLR quantization.

The port of ``polar_tpu.channel`` (the testbench channel model,
``testbench.cc:110-165``): unit-power BPSK symbols, AWGN with
``sigma = sqrt(1 / (2 * 10^(SNR/10)))``, LLR ``= 2/sigma^2 * y``, quantized
to saturating int8 (or kept in float). Noise is drawn from an explicit
``torch.Generator`` on the caller's device.
"""

from __future__ import annotations

import math

import torch

from .ops import arith


def noise_sigma(snr_db: float, signal_sigma: float = 1.0) -> float:
    """AWGN standard deviation for an Es/N0 in dB (``testbench.cc:114``)."""
    return math.sqrt(signal_sigma**2 / (2.0 * 10.0 ** (snr_db / 10.0)))


def ebn0_db(snr_db: float, code_rate: float, mod_bits: int = 1) -> float:
    """Eb/N0 in dB from Es/N0 (``testbench.cc:203-206``)."""
    sigma = noise_sigma(snr_db)
    spectral_efficiency = code_rate * mod_bits
    return 10.0 * math.log10(1.0 / (spectral_efficiency * 2.0 * sigma * sigma))


def snr_params(snr_db: float) -> tuple[float, float]:
    """(σ, 2/σ²) for an Es/N0 in dB, computed in float32 in the order of
    the JAX package's channel (``testbench.cc:114,162-163``). Both are
    returned as Python floats that hold float32 values exactly, so a
    kernel can take them as ``float`` arguments without rounding."""
    s = torch.tensor(snr_db, dtype=torch.float32)
    sigma2 = 0.5 * torch.pow(10.0, -s / 10.0)
    return float(torch.sqrt(sigma2)), float(2.0 / sigma2)


def channel_llrs(codeword, normals, sigma: float, scale: float,
                 dtype=torch.int8):
    """``quant(scale * (codeword + sigma * normals))`` in float32.

    Written as separate multiply and add ops (no fused multiply-add), the
    rounding the CUDA step kernel reproduces."""
    y = codeword.to(torch.float32) + sigma * normals
    return arith.quant(scale * y, dtype)


def awgn_llrs(gen: torch.Generator, codeword, snr_db: float,
              dtype=torch.int8, *, device):
    """Transmit ±1 symbols over AWGN and return quantized channel LLRs.

    ``codeword``: (..., N) hard symbols in {-1, +1} (any dtype). ``gen``
    is a generator on ``device``. Returns (..., N) LLRs in ``dtype`` —
    saturating int8 by default, matching
    ``PolarHelper<int8_t>::quant(2/sigma^2 * y)`` (``testbench.cc:160-165``).
    """
    codeword = codeword.to(device)
    sigma, scale = snr_params(snr_db)
    normals = torch.randn(codeword.shape, generator=gen, dtype=torch.float32,
                          device=device)
    return channel_llrs(codeword, normals, sigma, scale, dtype)
