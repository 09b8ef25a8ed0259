"""The plain reference of a non-systematic polar Monte-Carlo step, on the
program's kernel-draws path.

Plain PyTorch on element-major ``(N, B)`` tensors, built on
:mod:`reference.polar` (draws, channel, transform, Fast-SSC) and
:mod:`reference.construction` (the frozen set), and importing nothing of
the program under test. The upstream test bench's non-systematic mode
(xdsopl/polar ``testbench.cc`` line 48, ``systematic = false``; lines
147-149, ``PolarEncoder``) encodes with one transform and counts the
decoded message against the sent one.

* Keys: a step takes **two** Philox keys from the point's generator, each
  two 32-bit words drawn by ``torch.randint(0, 2**32, (2,),
  dtype=int64)``: first the message's, then the noise's (call word 0).
* Message: words ``[0, K)`` of each frame's stream under the message key,
  lowest bit 1 -> -1, in information-row order.
* Encode: frozen rows +1, the message at the information rows in order,
  one polar transform (:meth:`reference.polar.Code.reencode`).
* Noise: words ``[0, 2N)`` under the noise key; normal ``c`` of a frame is
  ``sqrt(-2 ln u(word c)) * cos(2 pi u(word N + c))``, the cosine half of a
  Box-Muller pair only, every float32 operation rounded on its own.
* Channel and quantizer: :func:`reference.polar.channel`.
* Decode: :class:`reference.polar.Decoder`, read as u: the (K, B) message
  estimate in {-1, 0, +1}.
* Counters, in the u domain and the bool domain: decoded against message
  on (K, B) (an error is a 0 or a sign that differs), frames with an error,
  zeros, and on (N, B) the LLRs of the wrong sign and those that are 0.

Departures from the upstream: its message bits and noise come from
``std::mt19937`` and ``std::normal_distribution`` (a Box-Muller pair gives
two normals there); here they are the program's Philox words, so that a
step can be replayed from its keys. The upstream counts ``decoded * message
<= 0`` and ``llr * codeword < 0`` on products, which the bool forms above
equal for ±1 message and codeword.
"""

from __future__ import annotations

import torch

from . import construction, polar


def step_keys(gen: torch.Generator) -> tuple[tuple[int, int],
                                             tuple[int, int]]:
    """(message key, noise key) of one step, drawn from the point's host
    generator in the program's order."""
    return tuple(tuple(int(s) for s in torch.randint(
        0, 2**32, (2,), generator=gen, dtype=torch.int64)) for _ in range(2))


def normals_cos(w: torch.Tensor) -> torch.Tensor:
    """(2N, B) words -> (N, B) normals: radius from row c, angle from row
    N + c, the cosine only."""
    n = w.shape[0] // 2
    r = torch.sqrt(-2.0 * torch.log(polar.unit(w[:n])))
    return r * polar.sincos_2pi(polar.unit(w[n:]))[0]


class Code(polar.Code):
    """A non-systematic polar code for the reference: its frozen mask, its
    decoder at ``bits`` bits, its encode (``reencode``) and its step."""

    def step_counters(self, keys, snr_db: float, batch: int,
                      chunk: int) -> list[int]:
        """The five counters of one step of ``batch`` frames under
        ``keys`` = (message key, noise key), in chunks of frames."""
        kmsg, knoise = keys
        total = [0] * 5
        for f0 in range(0, batch, chunk):
            frames = range(f0, min(batch, f0 + chunk))
            w = polar.words(kmsg, frames, 0, self.k, self.device)
            msg = (1 - 2 * (w & 1)).to(torch.int8)
            cw = self.reencode(msg)
            w = polar.words(knoise, frames, 0, 2 * self.n, self.device)
            llr = polar.channel(cw, normals_cos(w), snr_db, self.bits)
            del w
            hat = self.decoder.decode(llr)
            zero = hat == 0
            err = zero | ((hat < 0) != (msg < 0))
            awgn = (llr != 0) & ((llr < 0) != (cw < 0))
            for i, c in enumerate((err.sum(), err.any(dim=0).sum(),
                                   zero.sum(), awgn.sum(), (llr == 0).sum())):
                total[i] += int(c)
        return total


def code_of(config: dict, device) -> Code:
    """The reference's code of a configuration file's ``level``, ``K`` and
    ``design_snr_offset_db``."""
    return Code(construction.frozen_mask(
        config["level"], config["K"], config["design_snr_offset_db"]),
        device)
