"""Traffic of bulk decoding of float32 LLRs: batches of unquantized channel
LLRs, already on the card, through the program's decoder entry,
``make_auto_decoder(code, output="u")``, frame-major float32 in and u
bits out.

The window, the latencies, the metrics and the check are
:class:`decode_stream.DecodeStream`'s, with the mix's parameters of that
kind (``batch``, ``snr_db``, ``pool``, ``in_flight``, ``check_batches``).
Only the pool and the reference differ: set-up makes the pool with
:mod:`reference.float32`'s encoder and channel (random messages,
systematic encode, AWGN, ``scale * (cw + sigma * n)`` in float32 with no
rounding to integers), on the card from the seed, and the check holds the
outputs against that reference's float min-sum decode of the same pool
batches (``bits_off``, limit 0: every operation of the decode is one
float32 operation rounded on its own, in a fixed order).
"""

from __future__ import annotations

import time

import torch

from kinds.decode_stream import DecodeStream
from reference import construction, float32


class DecodeStreamF32(DecodeStream):
    def __init__(self, config: dict, mix: dict, seed: int, device, wrap):
        t = time.perf_counter()
        import polar_tpu_torch as pt

        self.phases = {"import": time.perf_counter() - t}
        self.config, self.mix, self.seed = config, mix, seed
        self.device = device
        self.batch = int(mix["batch"])
        self.in_flight = int(mix["in_flight"])
        code = pt.make_code(config["level"], config["K"],
                            design_snr_offset_db=config[
                                "design_snr_offset_db"])
        self.n, self.k = code.N, code.K
        dec, self.desc = pt.make_auto_decoder(code, output="u",
                                              device=device)
        self.dec = wrap(dec) if wrap is not None else dec
        self.phases["build"] = time.perf_counter() - t - self.phases["import"]
        t = time.perf_counter()
        self.ref = float32.Code(construction.frozen_mask(
            config["level"], config["K"], config["design_snr_offset_db"]),
            device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.pool = self.ref.channel_batches(gen, float(mix["snr_db"]),
                                             int(mix["pool"]), self.batch)
        self._sync()
        self.phases["pool"] = time.perf_counter() - t
        for i, llr in enumerate(self.pool[:2]):
            t = time.perf_counter()
            self.dec(llr)
            self._sync()
            self.phases[f"warm{i}"] = time.perf_counter() - t

    def window(self, seconds: float, spans) -> dict:
        """The window of :class:`DecodeStream`; the record also holds the
        code's frozen mask, for the float kernel's work model."""
        record = super().window(seconds, spans)
        record["frozen"] = self.ref.frozen
        return record


def prepare(config: dict, mix: dict, seed: int, device, wrap=None):
    return DecodeStreamF32(config, mix, seed, device, wrap)
