"""Traffic of one deep Monte-Carlo SNR point of a non-systematic code, as a
BER campaign runs it on the program's kernel-draws path.

The window and the entry are :class:`campaign_point.CampaignPoint`'s:
``run_point`` with ``make_step``'s step, one call after another, each call
``steps_per_call`` steps of ``batch`` frames and a pull of the five
counters. The mix's parameters are that kind's.

On the draws path (``AUTO_STEP_PATH``'s ``"draws"`` on a card) each step
takes two Philox keys from the point's generator, the message's and then
the noise's, and :mod:`reference.nonsys` replays them. That holds for the
draws path's streams only, so before the window the run fails with a plain
message where the program counted its warm-up steps
(``polar_tpu_torch.ber.steps_by_path``) on another path. A program without
that counter runs unchecked there, and the check after the window still
compares every counter.

A ``wrap`` (the control of ``control.py``, the tests' planted faults) is
handed the step's decode entry, ``make_auto_decoder(code, output="u")``,
as the kind ``decode_stream`` hands it, and what it gives is the decoder
of the program's draws step (``make_step_body(rng="kernel")``: the
symbols, encoder and AWGN kernels, their plain versions on the CPU).

The check works out again the counters of ``check_steps`` calls drawn from
the seed after the window, the first and the last among them
(``counter_gap``, limit 0: the decode is bit-exact).
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from harness import BenchError, note
from kinds.campaign_point import WARM_CALLS, CampaignPoint, _frames_chunk
from reference import nonsys


def _path_counts() -> dict | None:
    """The program's steps by path so far, or ``None`` where the program
    has no such counter. Before the program is imported, every count is
    0."""
    ber = sys.modules.get("polar_tpu_torch.ber")
    if ber is None:
        return {}
    counts = getattr(ber, "steps_by_path", None)
    return None if counts is None else dict(counts)


class NonsysPoint(CampaignPoint):
    def __init__(self, config: dict, mix: dict, seed: int, device, wrap):
        if config["systematic"]:
            raise BenchError(f"{config['name']} is systematic; the kind "
                             "nonsys_point replays the non-systematic "
                             "draws path")
        before = _path_counts()
        super().__init__(config, mix, seed, device,
                         None if wrap is None else self._around(wrap))
        after = _path_counts()
        if after is None or before is None:
            note("the program counts no steps by path: the draws path is "
                 "not checked before the window")
            return
        ran = {k: v - before.get(k, 0) for k, v in after.items()
               if v != before.get(k, 0)}
        want = WARM_CALLS * self.spc
        if ran != {"draws": want}:
            raise BenchError(
                f"the program's {want} warm-up steps ran on the paths {ran}, "
                "not all on the draws path whose two keys a step the "
                "reference replays")

    def _around(self, wrap):
        """A wrap of ``make_step``'s step: the program's draws step around
        ``wrap`` of the step's decode entry."""
        def step(program_step):
            from polar_tpu_torch import ber

            dec = self.pt.make_auto_decoder(
                self.code, output="u", output_dtype=torch.int8,
                device=self.device)[0]
            draws = ber.make_step_body(self.code, systematic=False,
                                       rng="kernel", decoder=wrap(dec),
                                       device=self.device)
            return ber.chain_steps(draws) if self.spc > 1 else draws
        return step

    def check(self):
        """The checked calls' counters against the reference's: the sum of
        the absolute differences, limit 0; and the calls that differ. Only
        the reference and its two keys a step differ from
        ``CampaignPoint.check``."""
        calls = len(self.counters)
        rng = random.Random(self.seed)
        want = min(calls, int(self.mix["check_steps"]))
        picks = sorted({0, calls - 1} | set(rng.sample(range(calls), want)))
        ref = nonsys.code_of(self.config, self.device)
        replay = torch.Generator()
        replay.manual_seed(self.seed)
        keys = [nonsys.step_keys(replay) for _ in range(calls * self.spc)]
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
    return NonsysPoint(config, mix, seed, device, wrap)
