"""Traffic of bulk decoding: batches of channel LLRs, already on the card,
through the program's decoder entry, ``make_auto_decoder(code,
output="u")``, frame-major int8 in and u bits out.

Set-up makes a pool of ``pool`` batches of ``batch`` frames with the
plain reference's encoder and channel at ``snr_db`` (random messages,
systematic encode, AWGN, int8 LLRs), on the card from the seed. The window
is a closed loop that keeps ``in_flight`` batches in flight: the next
batch, the pool's next in turn, is submitted when the oldest completes.

Each batch's latency runs from a CUDA event recorded on an idle side
stream as the host submits it to an event recorded after its decode on the
decode's stream: the device's clock, so the submission is stamped within
microseconds and the completion exactly. ``decoded_frames_per_s`` is the
frames of all batches over the window's host seconds; the window ends when
the last batch submitted completes. ``decode_p95_ms`` is the 95th
percentile of all the window's batch latencies.

After the window the outputs of ``check_batches`` batches drawn from the
seed (by reservoir sampling over the window, with the first and the last)
are held against the reference's decode of the same pool batches.
"""

from __future__ import annotations

import collections
import random
import statistics
import time

import torch

from reference import construction, polar


def _frames_chunk(n: int, batch: int) -> int:
    """Frames the reference decodes at once (about 2^26 LLRs)."""
    return max(1, min(batch, (1 << 26) // n))


class DecodeStream:
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
        self.ref = polar.Code(construction.frozen_mask(
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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, spans) -> dict:
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        rng = random.Random(self.seed)
        keep = int(self.mix["check_batches"])
        kept: list = []           # (batch index, pool index, output)
        latencies: list = []
        flight = collections.deque()
        dec, pool = self.dec, self.pool

        def complete():
            i, p, out, e_sub, e_done = flight.popleft()
            if cuda:
                e_done.synchronize()
                latencies.append(e_sub.elapsed_time(e_done))
            else:                 # a CPU run: the host's clock
                latencies.append((time.perf_counter_ns() - e_sub) / 1e6)
            if i == 0:
                self.first = (i, p, out)
            elif len(kept) < keep:
                kept.append((i, p, out))
            else:                 # reservoir sampling over batches 1, 2, ...
                j = rng.randrange(i)
                if j < keep:
                    kept[j] = (i, p, out)
            self.last = (i, p, out)

        i = 0
        t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        while time.perf_counter_ns() < deadline:
            if len(flight) == self.in_flight:
                complete()
            p = i % len(pool)
            e_sub, e_done = time.perf_counter_ns(), None
            if cuda:
                e_sub = torch.cuda.Event(enable_timing=True)
                e_done = torch.cuda.Event(enable_timing=True)
                e_sub.record(side)
            with spans("decode"):
                out = dec(pool[p])
            if cuda:
                e_done.record()
            flight.append((i, p, out, e_sub, e_done))
            i += 1
        while flight:
            complete()
        self._sync()
        t1 = time.perf_counter_ns()
        self.kept = kept + [self.first, self.last]
        window_s = (t1 - t0) / 1e9
        return {
            "metrics": {
                "decoded_frames_per_s": i * self.batch / window_s,
                "decode_p95_ms": statistics.quantiles(
                    latencies, n=100, method="inclusive")[94],
            },
            "attempted": i,
            "window_ns": (t0, t1),
            "window_s": window_s,
            "frames": i * self.batch,
            "n": self.n,
            "k": self.k,
        }

    def release(self):
        del self.dec
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The u bits of the checked batches against the reference's
        decode of the same pool batches: bits that differ, limit 0 (the
        decode is bit-exact); and the batches that differ."""
        chunk = _frames_chunk(self.n, self.batch)
        want = {}
        off = bad = 0
        for _, p, out in sorted(self.kept, key=lambda t: t[1]):
            if p not in want:
                want = {p: self.ref.decode_frames(self.pool[p], chunk)}
            diff = int((out != want[p]).sum()) if out.shape == want[p].shape \
                else out.numel() + want[p].numel()
            off += diff
            bad += diff > 0
        return {"bits_off": (off, 0)}, bad


def prepare(config: dict, mix: dict, seed: int, device, wrap=None):
    return DecodeStream(config, mix, seed, device, wrap)
