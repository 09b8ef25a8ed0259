"""Batched polar encoders (non-systematic and systematic).

The port of ``polar_tpu.encode`` (``polar_encoder.hh``):

* non-systematic (lines 9-28): scatter message symbols into the non-frozen
  leaf slots (+1 into frozen slots) and apply the polar transform;
* systematic (lines 30-59, Arıkan 2011): transform, re-freeze, transform
  again — the transform is a GF(2) involution, so information bits appear
  verbatim at the non-frozen codeword positions.

All functions take ``(..., K)`` message batches of ±1 hard symbols and
return ``(..., N)`` codewords on the message's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .code.construction import PolarCode
from .ops.transform import polar_transform


def _info_index(code: PolarCode, device) -> torch.Tensor:
    return torch.as_tensor(code.info_indices, dtype=torch.long, device=device)


def _scatter_message(code: PolarCode, message, fill=1):
    """Place message symbols at info leaf slots; ``fill`` (+1) elsewhere."""
    if message.shape[-1] != code.K:
        raise ValueError(f"message last dim {message.shape[-1]} != K={code.K}")
    u = torch.full((*message.shape[:-1], code.N), fill, dtype=message.dtype,
                   device=message.device)
    u[..., _info_index(code, message.device)] = message
    return u


def encode(code: PolarCode, message):
    """Non-systematic encode: codeword = transform(scatter(message))."""
    return polar_transform(_scatter_message(code, message))


def encode_systematic(code: PolarCode, message):
    """Systematic encode: info bits appear verbatim in the codeword.

    ``transform(refreeze(transform(scatter(message))))`` — the structure of
    ``polar_encoder.hh:38-57``.
    """
    x = polar_transform(_scatter_message(code, message))
    frozen = torch.as_tensor(np.asarray(code.frozen, dtype=bool),
                             device=message.device)
    x = torch.where(frozen, torch.ones_like(x), x)
    return polar_transform(x)


def extract_systematic(code: PolarCode, u_message):
    """Recover the systematic message from decoded u-domain info bits:
    re-encode and gather the non-frozen codeword positions
    (``testbench.cc:177-183``)."""
    codeword = encode(code, u_message)
    return codeword[..., _info_index(code, u_message.device)]
