"""The caller's-decoder Monte-Carlo path, on the CPU: the step with the
kernel draws (symbols, block encoder, AWGN; their plain versions here)
around a pinned decoder, against polar_tpu's ``rng="pallas-bits"`` step on
the same words; the chained steps, the campaign with ``steps_per_call``,
the step-rate meter and the waterfall CLI.

The JAX step body draws its words from a key (``polar_tpu/ber.py:310-316``:
``split(key)`` → ``kmsg, knoise``, ``split(knoise)`` → ``k1, k2``, then
``jax.random.bits``); the same words go to the port's
``rng="kernel-bits"`` body, and the five counters must be equal.
"""

import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ber import make_step_body as j_step_body
from polar_tpu.decode.fastssc import make_fastssc_decoder as j_fastssc
from polar_tpu.ops.pallas.step_kernel import _snr_params
from polar_tpu_torch import ber, waterfall
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import channel_kernel, encode_kernel
from polar_tpu_torch.utils.benchmark import measure_step_rate


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _t(words):
    return torch.from_numpy(np.asarray(words).astype(np.int64))


@pytest.mark.parametrize("m,systematic", [(9, True), (10, False)])
def test_kernel_bits_step_matches_pallas_bits_step(m, systematic):
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    out = "systematic" if systematic else "u"
    body = jax.jit(j_step_body(
        jc, systematic=systematic, rng="pallas-bits", rng_interpret=True,
        decoder=j_fastssc(jc, output=out, output_dtype=jnp.int8)),
        static_argnums=2)
    port = ber.make_step_body(
        code, systematic=systematic, rng="kernel-bits", device="cpu",
        decoder=pt.make_fastssc_decoder(code, output=out,
                                        output_dtype=torch.int8))
    batch = 256
    for i, snr_db in enumerate((0.5, -1.0)):
        # the exactness rests on both sides' (σ, 2/σ²) being the same floats
        assert snr_params(snr_db) == tuple(
            float(x) for x in np.asarray(_snr_params(snr_db)))
        key = jax.random.PRNGKey(100 * m + i)
        want = {k: int(v) for k, v in body(key, snr_db, batch).items()}
        kmsg, knoise = jax.random.split(key)
        k1, k2 = jax.random.split(knoise)
        words = (_t(jax.random.bits(kmsg, (batch, jc.K), jnp.uint32)),
                 _t(jax.random.bits(k1, (batch, jc.N), jnp.uint32)),
                 _t(jax.random.bits(k2, (batch, jc.N), jnp.uint32)))
        got = {k: int(v) for k, v in port(None, snr_db, batch, words=words).items()}
        assert got == want, snr_db
    assert want["uncorrected_errors"] > 0 and want["awgn_errors"] > 0


def test_multi_step_equals_the_sum_of_single_steps():
    code = pt.make_code(6, rate=0.5)
    dec = pt.make_fastssc_decoder(code, output="systematic",
                                  output_dtype=torch.int8)
    for rng in ("torch", "kernel"):
        step = ber.make_step_body(code, decoder=dec, rng=rng, device="cpu")
        multi = ber.chain_steps(step)
        g1, g2 = _gen(4), _gen(4)
        got = multi(g1, 0.0, 100, 3)
        want = dict.fromkeys(got, 0)
        for _ in range(3):
            for k, v in step(g2, 0.0, 100).items():
                want[k] += int(v)
        assert {k: int(v) for k, v in got.items()} == want, rng
        assert want["uncorrected_errors"] > 0
    multi = pt.make_multi_step(code, decoder=dec, device="cpu")
    assert set(multi(_gen(1), 1.0, 32, 2)) == set(want)
    with pytest.raises(ValueError, match="steps"):
        multi(_gen(1), 1.0, 32, 0)


def test_campaign_steps_per_call_resumes(tmp_path):
    code = pt.make_code(5, rate=0.5)
    kw = dict(device="cpu", seed=2, batch=128, max_frames_per_point=1024,
              snr_range=(0.0, 3.0), snr_step=1.0, measure_throughput=False,
              steps_per_call=4)
    whole = pt.run_campaign(code, **kw)
    assert [p.frames for p in whole.points][0] == 1024   # 2 calls of 4 x 128
    ck = tmp_path / "ck.json"
    part = pt.run_campaign(code, checkpoint_path=ck, **{**kw, "snr_range": (0.0, 1.0)})
    assert len(part.points) == 2
    resumed = pt.run_campaign(code, checkpoint_path=ck, **kw)
    assert [p.__dict__ for p in resumed.points] == [p.__dict__ for p in whole.points]
    # a chained campaign counts what the single-step one counts
    single = pt.run_campaign(code, **{**kw, "steps_per_call": 1})
    assert [p.__dict__ for p in single.points] == [p.__dict__ for p in whole.points]


def test_pinned_decoder_paths_by_device():
    code = pt.make_code(7, rate=0.5)
    dec = pt.make_fastssc_decoder(code, output="systematic",
                                  output_dtype=torch.int8)
    args = (code, torch.int8, None, dec)
    assert ber._step_path(*args, "auto", "cuda") == "draws"
    assert ber._step_path(*args, "auto", "cpu") == "plain"
    assert ber._step_path(*args, False, "cuda") == "plain"
    assert ber._step_path(code, torch.int8, "qfloat", dec, "auto", "cuda") == "plain"
    assert ber._step_path(code, torch.float32, None, dec, "auto", "cuda") == "plain"
    assert ber._step_path(code, torch.int8, None, None, "auto", "cuda") == "fused"
    before = (dict(channel_kernel.plain_calls), dict(encode_kernel.plain_calls))
    step = pt.make_step(code, decoder=dec, device="cpu")
    out = step(_gen(0), 1.0, 64)
    assert set(out) == set(ber.step_kernel.COUNTERS)
    # the torch draws ran: no kernel and no plain version of one
    assert (channel_kernel.plain_calls, encode_kernel.plain_calls) == before
    with pytest.raises(ValueError, match="unknown rng"):
        ber.make_step_body(code, rng="pallas", device="cpu")
    with pytest.raises(ValueError, match="kernel-bits"):
        step(_gen(0), 1.0, 8, words=(None, None, None))
    bits = ber.make_step_body(code, decoder=dec, rng="kernel-bits", device="cpu")
    with pytest.raises(ValueError, match="pass words="):
        bits(_gen(0), 1.0, 8)


def test_run_point_takes_a_step_of_python_ints():
    code = pt.make_code(4, rate=0.5)
    calls = []

    def step(gen, snr_db, batch):
        calls.append(batch)
        return {"uncorrected_errors": 3, "frame_errors": 2,
                "ambiguity_erasures": 1, "awgn_errors": 5,
                "quantization_erasures": 0}

    point = pt.run_point(code, 1.0, gen=_gen(0), step=step, batch=16,
                         max_frames=64, device="cpu")
    assert calls == [16] * 4 and point.frames == 64
    assert (point.bit_errors, point.awgn_errors, point.ambiguity_erasures,
            point.quantization_erasures) == (12, 20, 4, 0)
    assert point.fer == 8 / 64


def test_measure_step_rate_is_positive():
    code = pt.make_code(6, rate=0.5)
    step = pt.make_step(code, decoder=pt.make_fastssc_decoder(
        code, output="systematic", output_dtype=torch.int8), device="cpu")
    rate = measure_step_rate(step, _gen(0), 1.0, 256, device="cpu", iters=4,
                             repeats=2, max_iters=64)
    assert math.isfinite(rate) and rate > 0


def test_waterfall_cli_prints_table_and_qef(tmp_path, capsys):
    out = tmp_path / "wf.json"
    argv = ["--m", "6", "--device", "cpu", "--batch", "256", "--max-frames",
            "512", "--snr-min", "1", "--snr-max", "9", "--snr-step", "1",
            "--steps-per-call", "2", "--no-throughput", "--out", str(out)]
    assert waterfall.main(argv) == 0
    cap = capsys.readouterr()
    rows = [line.split() for line in cap.out.splitlines()]
    assert len(rows) >= 5 and all(len(r) == 4 for r in rows)
    assert float(rows[0][0]) == 1.0 and float(rows[0][1]) > 0
    assert "Polar(64, 32)" in cap.err and "QEF at: " in cap.err
    saved = json.loads(out.read_text())
    assert len(saved["points"]) == len(rows)
    assert saved["qef_snr_db"] is not None
    assert f"QEF at: {saved['qef_snr_db']} SNR" in cap.err
