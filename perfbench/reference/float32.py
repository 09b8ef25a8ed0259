"""The benchmark's plain reference of the float32 decode: the channel
without quantization and Fast-SSC in float min-sum.

Plain PyTorch on element-major ``(N, B)`` tensors, written from the
upstream test bench's description of its other arithmetic (xdsopl/polar
``testbench.cc`` lines 49-53, ``code_type`` ``float``;
``polar_helper.hh`` lines 63-111, the float ops; ``polar_decoder.hh``, the
nodes). It imports nothing of the program under test; from
``reference.polar`` it takes the frozen set's tree, the systematic encode
and the SNR's parameters, which are the same for both arithmetics.

* Channel: ``llr = scale * (cw + sigma * n)`` in float32, each product and
  sum rounded on its own, with no rint and no clamp.
* Decode, every operation one float32 operation rounded on its own, in
  the upstream's order:

  - ``signum(x) = (x > 0) - (x < 0)``, so either zero gives +0;
  - f: ``signum(a) * signum(b) * min(|a|, |b|)``, the products left to
    right;
  - g: ``h * a + b`` with the left hard value ``h`` in {-1, 0, +1} (its
    product exact);
  - rate-0 left: ``a + b``; rate-1: ``signum``; repetition: the sum folded
    in halves, then ``signum`` of it (a zero sum gives a zero bit);
  - SPC: ``copysign(1, x)`` (-0 decides -1), the product of the
    decisions, the least ``|x|``, and every tied weakest decision
    multiplied by that product;
  - combine: the product of the hard values.

  With ``dtype=torch.bfloat16`` every operation rounds to bfloat16: the
  control, the precision below the configuration's.

Where it departs from the upstream: whole batches move as tensors, where
the test bench decodes one SIMD register of frames at a time; the message
is read from the leaves in the ±1 domain (0 where a leaf's hard value is
0), not as bits; the pool's messages and noise come from
``torch.randint`` / ``torch.randn`` on the benchmark's generator in place
of ``std::mt19937`` and ``std::normal_distribution``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import polar


def channel(cw: torch.Tensor, noise: torch.Tensor,
            snr_db: float) -> torch.Tensor:
    """float32 LLRs of ±1 symbols ``cw`` sent with unit normals."""
    sigma, scale = polar.snr_params(snr_db)
    return scale * (cw.to(torch.float32) + sigma * noise)


def _signum(x):
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


class Decoder:
    """Fast-SSC in float min-sum at ``dtype``: ``decode`` takes (N, B)
    float LLRs, rounds them to ``dtype`` and returns the (K, B) u estimate
    in {-1, 0, +1} as int8."""

    def __init__(self, frozen: np.ndarray, dtype=torch.float32):
        self.root = polar.tree(np.asarray(frozen, dtype=np.uint8))
        self.dtype = dtype

    def _f(self, s):
        a, b = s.chunk(2)
        return _signum(a) * _signum(b) * torch.minimum(a.abs(), b.abs())

    def _g(self, hard, s):
        a, b = s.chunk(2)
        return hard * a + b

    def _node(self, node, s, out):
        kind, level, left, right = node
        if kind == "rate0":
            return torch.ones_like(s)
        if kind == "rate1":
            hard = _signum(s)
            out.append(polar.transform(hard))
            return hard
        if kind == "rep":
            x = s
            while x.shape[0] > 1:
                a, b = x.chunk(2)
                x = a + b
            bit = _signum(x)
            out.append(bit)
            return bit.expand_as(s)
        if kind == "spc":
            hard = torch.where(torch.signbit(s), -1.0, 1.0).to(s.dtype)
            parity = torch.prod(hard, dim=0, keepdim=True)
            mag = s.abs()
            weak = mag.amin(dim=0, keepdim=True)
            hard = torch.where(mag == weak, hard * parity, hard)
            out.append(polar.transform(hard)[1:])
            return hard
        if kind == "rate0_left":
            a, b = s.chunk(2)
            hard_r = self._node(right, a + b, out)
            return torch.cat([hard_r, hard_r])
        hard_l = self._node(left, self._f(s), out)
        if kind == "rate1_right":
            hard_r = _signum(self._g(hard_l, s))
            out.append(polar.transform(hard_r))
        else:
            hard_r = self._node(right, self._g(hard_l, s), out)
        return torch.cat([hard_l * hard_r, hard_r])

    def decode(self, llr: torch.Tensor) -> torch.Tensor:
        out: list = []
        self._node(self.root, llr.to(self.dtype), out)
        return torch.cat(out).to(torch.int8)


class Code:
    """A systematic polar code for the float reference: its frozen mask,
    the float pool's encode and channel, and its decoder at ``dtype``."""

    def __init__(self, frozen: np.ndarray, device, dtype=torch.float32):
        self.frozen = np.asarray(frozen, dtype=np.uint8)
        self.n = self.frozen.size
        self.k = int((self.frozen == 0).sum())
        self.device = torch.device(device)
        self.frozen_t = torch.as_tensor(self.frozen.astype(bool),
                                        device=self.device)[:, None]
        self.decoder = Decoder(self.frozen, dtype)

    def channel_batches(self, gen: torch.Generator, snr_db: float,
                        count: int, batch: int) -> list[torch.Tensor]:
        """``count`` frame-major (B, N) float32 LLR batches of random
        messages, systematically encoded and sent over AWGN, drawn from
        ``gen`` (a generator on the device)."""
        out = []
        for _ in range(count):
            bits = torch.randint(0, 2, (self.n, batch), generator=gen,
                                 device=self.device, dtype=torch.int8)
            cw = polar.encode_systematic(self.frozen_t, 1 - 2 * bits)
            noise = torch.randn((self.n, batch), generator=gen,
                                device=self.device)
            out.append(channel(cw, noise, snr_db).t().contiguous())
        return out

    def decode_frames(self, llr: torch.Tensor, chunk: int) -> torch.Tensor:
        """(B, K) u estimates of frame-major (B, N) float LLRs, in
        chunks."""
        return torch.cat([self.decoder.decode(llr[f0:f0 + chunk].t()).t()
                          for f0 in range(0, llr.shape[0], chunk)])
