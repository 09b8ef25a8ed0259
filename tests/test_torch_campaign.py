"""The whole slice on the CPU: the port's BER campaign against polar_tpu's.

The two packages draw different random streams (Philox words and torch
generators against threefry), so the comparison is statistical: at every
shared SNR point the frame error rate lies within 4 pooled binomial
standard deviations, the bit error rate within 4 standard deviations of
the per-frame bound var(BER estimate) <= BER / frames, and the QEF lines
agree within 0.5 dB. Results files are interchangeable between the two
packages.
"""

import math

import numpy as np
import pytest

import polar_tpu as jpt
import polar_tpu_torch as pt

SIGMAS = 4.0
SETTINGS = dict(seed=3, batch=2048, max_frames_per_point=8192,
                snr_range=(0.0, 8.0), snr_step=0.5, measure_throughput=False)


def _within(f1, n1, f2, n2):
    p = (f1 + f2) / (n1 + n2)
    sd = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return abs(f1 / n1 - f2 / n2) <= SIGMAS * sd + 1e-12


def _ber_within(e1, n1, e2, n2, k):
    b = (e1 + e2) / ((n1 + n2) * k)
    sd = math.sqrt(b * (1 / n1 + 1 / n2))
    return abs(e1 / (n1 * k) - e2 / (n2 * k)) <= SIGMAS * sd + 1e-12


@pytest.fixture(scope="module")
def campaigns():
    code = pt.make_code(6, rate=0.5)
    port = pt.run_campaign(code, device="cpu", **SETTINGS)
    ref = jpt.run_campaign(jpt.make_code(6, rate=0.5), **SETTINGS)
    return code, port, ref


def test_campaign_tracks_jax(campaigns):
    code, port, ref = campaigns
    ref_pts = {round(p.snr_db, 6): p for p in ref.points}
    shared = 0
    for p in port.points:
        r = ref_pts.get(round(p.snr_db, 6))
        if r is None:
            continue
        shared += 1
        assert _within(p.fer * p.frames, p.frames, r.fer * r.frames, r.frames), p
        assert _ber_within(p.bit_errors, p.frames, r.bit_errors, r.frames,
                           code.K), p
    assert shared >= 6
    assert port.points[0].bit_errors > 0
    assert math.isfinite(port.qef_snr_db) and math.isfinite(ref.qef_snr_db)
    assert abs(port.qef_snr_db - ref.qef_snr_db) <= 0.5 + 1e-9


def test_fused_and_plain_chains_agree_in_distribution():
    code = pt.make_code(5, rate=0.5)
    kw = dict(device="cpu", batch=4096, max_frames=8192, target_bit_errors=10**9)
    import torch

    for systematic in (True, False):
        gen = torch.Generator()
        gen.manual_seed(1)
        fused = pt.run_point(code, 1.0, gen=gen, systematic=systematic, **kw)
        plain = pt.run_point(code, 1.0, gen=gen, systematic=systematic,
                             step=pt.make_step(code, systematic=systematic,
                                               fused=False, device="cpu"), **kw)
        assert _within(fused.fer * fused.frames, fused.frames,
                       plain.fer * plain.frames, plain.frames)
        assert _within(fused.awgn_errors, fused.frames * code.N,
                       plain.awgn_errors, plain.frames * code.N)


def test_result_files_interchange(campaigns, tmp_path):
    _, port, ref = campaigns
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    pt.save_result(port, a)
    jpt.save_result(ref, b)
    assert a.read_text().count("\n") > 10
    from_port = jpt.load_result(a)
    from_jax = pt.load_result(b)
    assert [p.__dict__ for p in from_port.points] == [p.__dict__ for p in port.points]
    assert [p.__dict__ for p in from_jax.points] == [p.__dict__ for p in ref.points]
    assert (from_port.qef_snr_db, from_port.seed) == (port.qef_snr_db, port.seed)
    assert (from_jax.code_n, from_jax.code_k, from_jax.systematic) == (64, 32, True)


def test_checkpoint_resume_is_identical(tmp_path):
    code = pt.make_code(4, rate=0.5)
    kw = dict(device="cpu", seed=9, batch=512, max_frames_per_point=1024,
              snr_range=(0.0, 3.0), snr_step=1.0, measure_throughput=False)
    whole = pt.run_campaign(code, **kw)
    ck = tmp_path / "ck.json"
    part = pt.run_campaign(code, checkpoint_path=ck,
                           **{**kw, "snr_range": (0.0, 1.0)})
    assert len(part.points) == 2
    resumed = pt.run_campaign(code, checkpoint_path=ck, **kw)
    assert [p.__dict__ for p in resumed.points] == [p.__dict__ for p in whole.points]


def test_campaign_measures_throughput_on_cpu():
    code = pt.make_code(3, rate=0.5)
    res = pt.run_campaign(code, device="cpu", batch=256, max_frames_per_point=256,
                          snr_range=(1.0, 1.0))
    assert len(res.points) == 1 and res.points[0].info_bits_per_sec > 0
    assert np.isfinite(res.peak_mbps)
