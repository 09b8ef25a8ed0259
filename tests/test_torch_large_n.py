"""The port's large-N step (block front → hybrid element-major decode →
counters), forced down to small codes by lowering the level threshold,
against the JAX package's chain and against the port's fused step.

Inject mode feeds the same message symbols and normals (drawn with JAX's
own bit maps from one key) to the JAX chain — its block front and its
hybrid decoder, Pallas kernels in interpret mode, then its counters
(``polar_tpu/ber.py:323-359``) — and to the port; native mode draws the
fused step's Philox words, so the large-N step and the fused step count
alike on the same seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.decode.fastssc import make_fastssc_decoder as j_fastssc
from polar_tpu.ops.pallas.step_kernel import (_bits_to_normals, _bits_to_sym,
                                              _snr_params, make_pallas_front_blocks)
from polar_tpu_torch import ber
from polar_tpu_torch.decode import auto as decode_auto
from polar_tpu_torch.ops.cuda import (count_kernel, front_kernel, step_kernel,
                                      subtree_kernel)


def _jax_chain(jc, systematic, snr_db, kernel_level):
    """polar_tpu's large-N step_front on injected inputs, jitted."""
    front = make_pallas_front_blocks(jc, frame_tile=128, block_level=8,
                                     interpret=True, prng="inject",
                                     systematic=systematic)
    dec = j_fastssc(jc, output="codeword" if systematic else "u",
                    output_dtype=jnp.int8, kernel_level=kernel_level,
                    kernel_frame_tile=128, kernel_interpret=True).lane_major
    info_rows = jnp.asarray(jc.frozen == 0).reshape(jc.N, 1)
    info_idx = jnp.asarray(jc.info_indices)

    @jax.jit
    def chain(msg, nrm):
        outs = front(msg, nrm, snr_db)
        if systematic:
            llr, cw = outs
            hat = dec(llr)
            zero_d = (hat == 0) & info_rows
            err = (hat != cw) & info_rows
        else:
            llr, cw, u0 = outs
            hat = dec(llr)
            zero_d = hat == 0
            err = zero_d | ((hat < 0) != (u0[info_idx, :] < 0))
        awgn = (llr != 0) & ((llr < 0) != (cw < 0))
        return jnp.stack([jnp.sum(err), jnp.sum(jnp.any(err, axis=0)),
                          jnp.sum(zero_d), jnp.sum(awgn), jnp.sum(llr == 0)])

    return chain


@pytest.mark.parametrize("systematic", [True, False])
def test_large_n_step_inject_matches_jax_chain(monkeypatch, systematic):
    jc = jpt.make_code(9, rate=0.5)
    code = pt.code_from_jax(jc)
    monkeypatch.setattr(ber, "STEP_KERNEL_MAX_LEVEL", 8)
    assert ber._step_path(code, torch.int8, None, None, "auto", "cpu") == "front"
    snr = -1.0
    kmsg, knoise = jax.random.split(jax.random.PRNGKey(3))
    msg = np.array(_bits_to_sym(jax.random.bits(kmsg, (jc.N, 128), jnp.uint32)),
                   np.int8)
    nrm = np.array(_bits_to_normals(jax.random.bits(knoise, (jc.N, 128),
                                                    jnp.uint32)))
    want = np.asarray(_jax_chain(jc, systematic, snr, 8)(jnp.asarray(msg),
                                                         jnp.asarray(nrm)))
    chain = ber.make_front_chain(code, systematic=systematic, kernel_level=8)
    params = tuple(float(x) for x in np.asarray(_snr_params(snr)))
    got = chain(params, msg_t=torch.from_numpy(msg), normals_t=torch.from_numpy(nrm))
    assert got.tolist() == want.tolist()
    assert want[0] > 0 and want[3] > 0


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("m", [9, 10])
def test_large_n_step_native_matches_fused_step(monkeypatch, m, systematic):
    code = pt.make_code(m, rate=0.5)
    fused = ber.make_step(code, systematic=systematic, device="cpu")
    monkeypatch.setattr(ber, "STEP_KERNEL_MAX_LEVEL", m - 1)
    large = ber.make_step(code, systematic=systematic, device="cpu")
    for seed, snr in ((1, -1.5), (2, 0.5), (3, 3.0)):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        a = {k: int(v) for k, v in large(g1, snr, 100).items()}
        b = {k: int(v) for k, v in fused(g2, snr, 100).items()}
        assert a == b, (snr, a, b)
        if snr < 0:
            assert a["uncorrected_errors"] > 0


def test_large_n_campaign_repeats_the_fused_campaign(monkeypatch):
    """run_campaign through the front path counts exactly what the fused
    step counts on the same seeds, through the plain versions only."""
    code = pt.make_code(8, rate=0.5)
    kw = dict(device="cpu", seed=4, batch=256, max_frames_per_point=512,
              snr_range=(0.0, 1.0), snr_step=0.5, measure_throughput=False)
    want = pt.run_campaign(code, **kw)
    monkeypatch.setattr(ber, "STEP_KERNEL_MAX_LEVEL", 7)
    # the front path's hybrid branch, which takes front_decode_cfg
    monkeypatch.setattr(ber, "FRONT_WHOLE_MAX_LEVEL", 0)
    monkeypatch.setattr(decode_auto, "HYBRID_MIN_LEVEL", 8)
    counts = (subtree_kernel.launches, front_kernel.launches,
              count_kernel.launches, step_kernel.plain_calls,
              subtree_kernel.plain_calls, count_kernel.plain_calls,
              front_kernel.plain_calls)
    before = [dict(c) for c in counts]
    got = pt.run_campaign(code, front_decode_cfg=5, **kw)
    assert [p.__dict__ for p in got.points] == [p.__dict__ for p in want.points]
    assert got.points[0].bit_errors > 0
    after = [dict(c) for c in counts]
    assert after[:3] == before[:3]                      # no launches on the CPU
    assert after[3] == before[3]                        # no fused step
    # every plain version of the front path ran; the draws path's u
    # counter did not
    assert all(a[k] > b[k] for a, b in zip(after[4:], before[4:]) for k in a
               if k != "count_frames_plain")
    assert after[5]["count_frames_plain"] == before[5]["count_frames_plain"]
