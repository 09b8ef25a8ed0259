"""polar_tpu_torch — the polar-coding framework in PyTorch, with CUDA kernels.

The port of ``polar_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100:
code construction, Fast-SSC compilation, systematic and non-systematic
encoding, saturating-int8 Fast-SSC and SC decoding and AWGN Monte-Carlo
BER campaigns. On a CUDA device the decoders, the Monte-Carlo steps and the
channel and encoder draws run as hand-written CUDA kernels (``csrc/``,
built with nvcc at first use); on the CPU their plain PyTorch versions
run. Importing this package imports neither JAX nor ``polar_tpu``.

Quick start::

    import torch, polar_tpu_torch as pt

    code = pt.make_code(10, rate=0.5)                    # Polar(1024, 512)
    result = pt.run_campaign(code, device="cuda")        # BER waterfall

The CLIs: ``python -m polar_tpu_torch.waterfall --help`` (one BER
waterfall), ``python -m polar_tpu_torch.curve_set`` (the curve set per
code length and mode) and ``python -m polar_tpu_torch.throughput`` (decode
frames/s per code length).
"""

from .ber import (CampaignResult, SnrPoint, make_multi_step, make_step,
                  run_campaign, run_point)
from .campaign_io import load_result, plot_waterfall, save_result
from .channel import awgn_llrs, ebn0_db, noise_sigma
from .code.compiler import Node, compile_code, compile_program
from .code.construction import (
    PolarCode,
    bhattacharyya_dual,
    bhattacharyya_logpe,
    code_from_jax,
    design_snr_db,
    erasure_probability_for_snr_db,
    frozen_mask_fixed_k,
    frozen_mask_threshold,
    make_code,
    make_code_threshold,
)
from .code.store import load_code, save_code
from .decode.auto import make_auto_decoder, make_kernel_decoder
from .decode.fastssc import make_fastssc_decoder
from .decode.sc import make_sc_decoder
from .encode import encode, encode_systematic, extract_systematic
from .ops.transform import polar_transform

__version__ = "0.1.0"

__all__ = [
    "PolarCode",
    "make_code",
    "make_code_threshold",
    "code_from_jax",
    "frozen_mask_fixed_k",
    "frozen_mask_threshold",
    "bhattacharyya_logpe",
    "bhattacharyya_dual",
    "design_snr_db",
    "erasure_probability_for_snr_db",
    "Node",
    "compile_code",
    "compile_program",
    "save_code",
    "load_code",
    "polar_transform",
    "encode",
    "encode_systematic",
    "extract_systematic",
    "make_sc_decoder",
    "make_fastssc_decoder",
    "make_auto_decoder",
    "make_kernel_decoder",
    "awgn_llrs",
    "noise_sigma",
    "ebn0_db",
    "make_step",
    "make_multi_step",
    "run_point",
    "run_campaign",
    "SnrPoint",
    "CampaignResult",
    "save_result",
    "load_result",
    "plot_waterfall",
]
