"""The benchmark's plain reference of a polar Monte-Carlo step and decode.

Plain PyTorch on element-major ``(N, B)`` tensors (the code axis leads,
frames trail), written from the upstream test bench's description
(xdsopl/polar: ``polar_encoder.hh``, ``polar_decoder.hh``,
``polar_helper.hh``, ``testbench.cc``). It imports nothing of the program
under test and takes nothing it made: the frozen set, the draws, the
encode, the channel, the decode and the counters are all worked out here.

* Draws: Philox4x32-10 (Salmon et al., SC'11). Word ``w`` of frame ``f``
  is lane ``w % 4`` of ``philox(counter=(f, w // 4, call, 0), key=(s0,
  s1))``. A frame takes 2N words: ``[0, N/2)`` radii and ``[N/2, N)``
  angles of a Box-Muller pair (cos fills rows ``[0, N/2)``, sin rows
  ``[N/2, N)``), ``[N, 2N)`` the message symbols (lowest bit 1 -> -1).
  The uniform map, the quadrant-reduced sine and cosine polynomials and
  every product and sum are float32, each rounded on its own.
* Systematic encode: transform, frozen rows back to +1, transform.
* Channel: ``llr = clamp(rint(scale * (cw + sigma * n)))``, ties to even,
  with ``(sigma, 2 / sigma^2)`` from the Es/N0 in float32.
* Decode: Fast-SSC on the pruned tree (rate-0, rate-1, repetition, SPC,
  rate-0 left, rate-1 right), in saturating fixed point of ``bits`` bits
  (8: the test bench's int8; 4: the benchmark's lower-precision control):
  ``qabs`` and the g update clamp their soft operand at ``lo + 1``, SPC
  flips every tied weakest bit, and the message is read from the leaves.
* Counters (systematic): the re-encoded estimate against the sent codeword
  at the information rows, in the bool domain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

COUNTERS = ("uncorrected_errors", "frame_errors", "ambiguity_erasures",
            "awgn_errors", "quantization_erasures")
_MASK = 0xFFFFFFFF


# -- draws --------------------------------------------------------------

def _mul32(a: int, b: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the constant ``a`` and the
    32-bit words ``b`` (int64 tensors), built from 16-bit halves."""
    lo_part = a * (b & 0xFFFF)
    hi_part = a * (b >> 16)
    mid = lo_part + ((hi_part & 0xFFFF) << 16)
    return ((hi_part >> 16) + (mid >> 32)) & _MASK, mid & _MASK


def philox(c0, c1, c2, c3, key):
    """Philox4x32-10 over int64 tensors holding 32-bit words."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK
            k1 = (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mul32(0xD2511F53, c0)
        hi1, lo1 = _mul32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(key, frames: range, first: int, count: int, device,
          call: int = 0) -> torch.Tensor:
    """(count, len(frames)) int64 words ``first .. first + count - 1`` of
    each frame's stream (``first`` and ``count`` multiples of 4)."""
    blocks = torch.arange(first // 4, (first + count) // 4,
                          dtype=torch.int64, device=device)[:, None]
    frame = torch.arange(frames.start, frames.stop, dtype=torch.int64,
                         device=device)[None, :]
    shape = (blocks.shape[0], frame.shape[1])
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    lanes = philox(frame + zero, blocks + zero, zero + (call & _MASK), zero,
                   key)
    return torch.stack(lanes, dim=1).reshape(count, shape[1])


def _f32(x: float) -> float:
    return float(np.float32(x))


def unit(w: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in (0, 1]: the top 24 bits plus half an ulp."""
    return ((w >> 8).to(torch.float32) + 0.5) * _f32(1.0 / (1 << 24))


def sincos_2pi(u: torch.Tensor):
    """(cos 2 pi u, sin 2 pi u): quadrant reduction, then Taylor
    polynomials of degree 8 and 9 on [-pi/4, pi/4]."""
    t = 4.0 * u
    k = torch.round(t)
    phi = (t - k) * _f32(math.pi / 2.0)
    x2 = phi * phi
    c = 1.0 + x2 * (_f32(-1 / 2) + x2 * (
        _f32(1 / 24) + x2 * (_f32(-1 / 720) + x2 * _f32(1 / 40320))))
    s = phi * (1.0 + x2 * (_f32(-1 / 6) + x2 * (
        _f32(1 / 120) + x2 * (_f32(-1 / 5040) + x2 * _f32(1 / 362880)))))
    ki = k.to(torch.int32)
    swap = (ki & 1) == 1
    sign_c = (1 - ((ki + 1) & 2)).to(torch.float32)
    sign_s = (1 - (ki & 2)).to(torch.float32)
    return sign_c * torch.where(swap, s, c), sign_s * torch.where(swap, c, s)


def normals(w: torch.Tensor) -> torch.Tensor:
    """(N, B) words -> (N, B) normals by Box-Muller: rows [0, N/2) are
    radii, rows [N/2, N) angles."""
    h = w.shape[0] // 2
    r = torch.sqrt(-2.0 * torch.log(unit(w[:h])))
    c, s = sincos_2pi(unit(w[h:]))
    return torch.cat([r * c, r * s], dim=0)


def snr_params(snr_db: float) -> tuple[float, float]:
    """(sigma, 2 / sigma^2) of an Es/N0 in dB, float32 on the host
    (``testbench.cc`` lines 114 and 162-163)."""
    s = torch.tensor(snr_db, dtype=torch.float32)
    sigma2 = 0.5 * torch.pow(10.0, -s / 10.0)
    return float(torch.sqrt(sigma2)), float(2.0 / sigma2)


def quantize(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """clamp(rint(x)) to ``bits``-bit two's complement, as int16."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return torch.round(x).clamp(lo, hi).to(torch.int16)


def channel(cw: torch.Tensor, noise: torch.Tensor, snr_db: float,
            bits: int = 8) -> torch.Tensor:
    """Quantized LLRs of ±1 symbols ``cw`` sent with unit normals."""
    sigma, scale = snr_params(snr_db)
    y = cw.to(torch.float32) + sigma * noise
    return quantize(scale * y, bits)


# -- encode -------------------------------------------------------------

def transform(x: torch.Tensor) -> torch.Tensor:
    """The polar transform along axis 0 on ±1 symbols (XOR as product)."""
    n = x.shape[0]
    tail = x.shape[1:]
    h = 1
    while h < n:
        v = x.reshape(n // (2 * h), 2, h, *tail)
        x = torch.stack([v[:, 0] * v[:, 1], v[:, 1]], dim=1).reshape(n, *tail)
        h *= 2
    return x


def encode_systematic(frozen: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Systematic codeword of (N, B) ±1 symbols ``u`` (frozen rows are
    set to +1 here); ``frozen`` is an (N, 1) bool mask."""
    one = torch.ones_like(u)
    x = transform(torch.where(frozen, one, u))
    return transform(torch.where(frozen, one, x))


# -- decode -------------------------------------------------------------

def tree(frozen: np.ndarray):
    """The pruned Fast-SSC tree of a frozen mask, as nested tuples
    ``(kind, level, left, right)``."""
    n = frozen.size
    level = n.bit_length() - 1
    half = n // 2
    lc, rc = int(frozen[:half].sum()), int(frozen[half:].sum())
    if lc == half and rc == half:
        return ("rate0", level, None, None)
    if lc == 0 and rc == 0:
        return ("rate1", level, None, None)
    if lc == half and rc == half - 1 and not frozen[-1]:
        return ("rep", level, None, None)
    if lc == 1 and rc == 0 and frozen[0]:
        return ("spc", level, None, None)
    if level < 2:
        raise ValueError("a two-leaf node of pattern (info, frozen)")
    if lc == half:
        return ("rate0_left", level, None, tree(frozen[half:]))
    if rc == 0:
        return ("rate1_right", level, tree(frozen[:half]), None)
    return ("branch", level, tree(frozen[:half]), tree(frozen[half:]))


class Decoder:
    """Fast-SSC in ``bits``-bit saturating fixed point: ``decode`` takes
    (N, B) integer LLRs, saturates them to ``bits`` bits and returns the
    (K, B) u estimate in {-1, 0, +1} as int8."""

    def __init__(self, frozen: np.ndarray, bits: int = 8):
        self.root = tree(np.asarray(frozen, dtype=np.uint8))
        self.lo, self.hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    def _sat(self, x):
        return x.clamp(self.lo, self.hi)

    def _abs(self, x):
        return x.clamp(min=self.lo + 1).abs()

    def _f(self, s):
        a, b = s.chunk(2)
        return a.clamp(-1, 1) * b.clamp(-1, 1) * torch.minimum(self._abs(a),
                                                               self._abs(b))

    def _g(self, hard, s):
        a, b = s.chunk(2)
        return self._sat(hard * a.clamp(min=self.lo + 1) + b)

    def _node(self, node, s, out):
        kind, level, left, right = node
        if kind == "rate0":
            return torch.ones_like(s)
        if kind == "rate1":
            hard = s.clamp(-1, 1)
            out.append(transform(hard))
            return hard
        if kind == "rep":
            x = s
            while x.shape[0] > 1:
                a, b = x.chunk(2)
                x = self._sat(a + b)
            bit = x.clamp(-1, 1)
            out.append(bit)
            return bit.expand_as(s)
        if kind == "spc":
            hard = torch.where(s < 0, -1, 1).to(s.dtype)
            parity = torch.prod(hard, dim=0, keepdim=True).to(s.dtype)
            mag = self._abs(s)
            weak = mag.amin(dim=0, keepdim=True)
            hard = torch.where(mag == weak, hard * parity, hard)
            out.append(transform(hard)[1:])
            return hard
        if kind == "rate0_left":
            a, b = s.chunk(2)
            hard_r = self._node(right, self._sat(a + b), out)
            return torch.cat([hard_r, hard_r])
        hard_l = self._node(left, self._f(s), out)
        if kind == "rate1_right":
            hard_r = self._g(hard_l, s).clamp(-1, 1)
            out.append(transform(hard_r))
        else:
            hard_r = self._node(right, self._g(hard_l, s), out)
        return torch.cat([hard_l * hard_r, hard_r])

    def decode(self, llr: torch.Tensor) -> torch.Tensor:
        out: list = []
        self._node(self.root, self._sat(llr.to(torch.int16)), out)
        return torch.cat(out).to(torch.int8)


# -- the campaign step and the decode pool --------------------------------

class Code:
    """A systematic polar code for the reference: its frozen mask on the
    host and on ``device``, and its decoder at ``bits`` bits."""

    def __init__(self, frozen: np.ndarray, device, bits: int = 8):
        self.frozen = np.asarray(frozen, dtype=np.uint8)
        self.n = self.frozen.size
        self.k = int((self.frozen == 0).sum())
        self.device = torch.device(device)
        self.frozen_t = torch.as_tensor(self.frozen.astype(bool),
                                        device=self.device)[:, None]
        self.info = torch.as_tensor(np.flatnonzero(self.frozen == 0),
                                    device=self.device)
        self.bits = bits
        self.decoder = Decoder(self.frozen, bits)

    def reencode(self, u: torch.Tensor) -> torch.Tensor:
        """The codeword of the (K, B) u estimate: u at the information
        rows, +1 at the frozen ones, transformed (no root shortcut)."""
        full = torch.ones((self.n, u.shape[1]), dtype=u.dtype,
                          device=u.device)
        full[self.info] = u
        return transform(full)

    def step_counters(self, key, snr_db: float, batch: int,
                      chunk: int) -> list[int]:
        """The five counters of one campaign step of ``batch`` frames
        drawn under Philox ``key`` (call word 0), in chunks of frames."""
        total = [0] * 5
        for f0 in range(0, batch, chunk):
            frames = range(f0, min(batch, f0 + chunk))
            w = words(key, frames, 0, 2 * self.n, self.device)
            msg = (1 - 2 * (w[self.n:] & 1)).to(torch.int8)
            cw = encode_systematic(self.frozen_t, msg)
            llr = channel(cw, normals(w[:self.n]), snr_db, self.bits)
            del w, msg
            cw_hat = self.reencode(self.decoder.decode(llr))
            info = ~self.frozen_t
            err = (cw_hat != cw) & info
            zero = (cw_hat == 0) & info
            awgn = (llr != 0) & ((llr < 0) != (cw < 0))
            for i, c in enumerate((err.sum(), err.any(dim=0).sum(),
                                   zero.sum(), awgn.sum(), (llr == 0).sum())):
                total[i] += int(c)
        return total

    def channel_batches(self, gen: torch.Generator, snr_db: float,
                        count: int, batch: int) -> list[torch.Tensor]:
        """``count`` frame-major (B, N) int8 LLR batches of random
        messages, systematically encoded and sent over AWGN, drawn from
        ``gen`` (a generator on the device) in a few large calls; int8
        whatever the decoder's bits, as both sides are handed them."""
        out = []
        for _ in range(count):
            bits = torch.randint(0, 2, (self.n, batch), generator=gen,
                                 device=self.device, dtype=torch.int8)
            cw = encode_systematic(self.frozen_t, 1 - 2 * bits)
            noise = torch.randn((self.n, batch), generator=gen,
                                device=self.device)
            out.append(channel(cw, noise, snr_db).to(torch.int8)
                       .t().contiguous())
        return out

    def decode_frames(self, llr: torch.Tensor, chunk: int) -> torch.Tensor:
        """(B, K) u estimates of frame-major (B, N) LLRs, in chunks."""
        return torch.cat([
            self.decoder.decode(llr[f0:f0 + chunk].t().to(torch.int16)).t()
            for f0 in range(0, llr.shape[0], chunk)])
