"""Traffic of one deep Monte-Carlo SNR point, as a BER campaign runs it.

The window calls the program's campaign entry, ``polar_tpu_torch.run_point``,
with the step of ``make_step`` (or of ``make_multi_step`` when the mix asks
for more than one step a call), one call after another (a closed loop),
each call ``steps_per_call`` steps of ``batch`` frames followed by
``run_point``'s pull of the five counters to the host. The point's error
target is out of reach, so only the window's clock ends it, as it is for a
deep point; the window ends at a pull.

The mix's parameters: ``batch``, ``snr_db``, ``steps_per_call`` and
``check_steps`` (the steps, drawn from the seed after the window, whose
counters the plain reference works out again; the first and the last are
always among them).

Every step draws its Philox key, two 32-bit words, from the point's host
generator (seeded by the run's seed) with ``torch.randint(0, 2**32, (2,),
dtype=int64)``, and draws its frames with call word 0: the reference
replays that generator to find each checked step's key.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from reference import construction, polar

TARGET_OUT_OF_REACH = 1 << 62
WARM_CALLS = 2


def _frames_chunk(n: int, batch: int) -> int:
    """Frames the reference takes at once (about 2^26 words of draws)."""
    return max(1, min(batch, (1 << 25) // n))


class CampaignPoint:
    def __init__(self, config: dict, mix: dict, seed: int, device, wrap):
        t = time.perf_counter()
        import polar_tpu_torch as pt

        self.phases = {"import": time.perf_counter() - t}
        self.pt = pt
        self.config, self.mix, self.seed = config, mix, seed
        self.device = device
        self.batch = int(mix["batch"])
        self.snr = float(mix["snr_db"])
        self.spc = int(mix.get("steps_per_call", 1))
        self.code = pt.make_code(config["level"], config["K"],
                                 design_snr_offset_db=config[
                                     "design_snr_offset_db"])
        make = pt.make_multi_step if self.spc > 1 else pt.make_step
        step = make(self.code, systematic=config["systematic"],
                    dtype=torch.int8, device=device)
        self.step = wrap(step) if wrap is not None else step
        self.phases["build"] = time.perf_counter() - t - self.phases["import"]
        warm = torch.Generator()
        warm.manual_seed(seed ^ 0x5EED)
        for i in range(WARM_CALLS):
            t = time.perf_counter()
            self._call(warm, self.step)
            self.phases[f"warm{i}"] = time.perf_counter() - t
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _call(self, gen, step):
        """One ``run_point`` call of ``steps_per_call`` steps: the counters
        as pulled, in the reference's order."""
        p = self.pt.run_point(
            self.code, self.snr, gen=gen, step=step,
            systematic=self.config["systematic"], dtype=torch.int8,
            batch=self.batch, max_frames=self.batch * self.spc,
            target_bit_errors=TARGET_OUT_OF_REACH,
            steps_per_call=self.spc, device=self.device)
        return (p.bit_errors, round(p.fer * p.frames), p.ambiguity_erasures,
                p.awgn_errors, p.quantization_erasures)

    def window(self, seconds: float, spans) -> dict:
        step = self.step

        def timed_step(*args):
            with spans("step"):
                return step(*args)

        gen = torch.Generator()
        gen.manual_seed(self.seed)
        self.counters = []
        t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        while True:
            with spans("run_point"):
                self.counters.append(self._call(gen, timed_step))
            t1 = time.perf_counter_ns()
            if t1 >= deadline:
                break
        calls = len(self.counters)
        frames = calls * self.spc * self.batch
        window_s = (t1 - t0) / 1e9
        return {
            "metrics": {"sim_frames_per_s": frames / window_s},
            "attempted": calls,
            "window_ns": (t0, t1),
            "window_s": window_s,
            "frames": frames,
            "n": self.code.N,
            "k": self.code.K,
        }

    def release(self):
        del self.step, self.code
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        """The checked calls' counters against the reference's: the sum of
        the absolute differences, limit 0 (the decode is bit-exact); and
        the calls that differ."""
        calls = len(self.counters)
        rng = random.Random(self.seed)
        want = min(calls, int(self.mix["check_steps"]))
        picks = sorted({0, calls - 1} | set(rng.sample(range(calls), want)))
        ref = polar.Code(construction.frozen_mask(
            self.config["level"], self.config["K"],
            self.config["design_snr_offset_db"]), self.device)
        replay = torch.Generator()
        replay.manual_seed(self.seed)
        keys = [tuple(int(s) for s in torch.randint(
            0, 2**32, (2,), generator=replay, dtype=torch.int64))
            for _ in range(calls * self.spc)]
        chunk = _frames_chunk(ref.n, self.batch)
        gap = bad = 0
        for c in picks:
            want_c = np.zeros(5, dtype=np.int64)
            for s in range(c * self.spc, (c + 1) * self.spc):
                want_c += ref.step_counters(keys[s], self.snr, self.batch,
                                            chunk)
            off = int(np.abs(np.asarray(self.counters[c]) - want_c).sum())
            gap += off
            bad += off > 0
        return {"counter_gap": (gap, 0)}, bad


def prepare(config: dict, mix: dict, seed: int, device, wrap=None):
    return CampaignPoint(config, mix, seed, device, wrap)
