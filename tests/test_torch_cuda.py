"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: it is marked ``cuda`` and skips
without one. The file imports neither JAX nor polar_tpu, so it runs where
only torch is installed; ``tests/conftest.py`` imports JAX, so on such a
machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import polar_tpu_torch as pt
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.decode.auto import make_kernel_decoder
from polar_tpu_torch.ops.cuda import decoder_kernel, step_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _llrs(dev, n, b, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-128, 128, (n, b), generator=g, device=dev,
                      dtype=torch.int8)
    x[:, 0] = -128
    x[:, 1] = 0
    return x


@pytest.mark.parametrize("m", [2, 5, 10, 13])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_decoder_kernel_matches_plain(dev, m, batch):
    c = pt.make_code(m, rate=0.5)
    llr = _llrs(dev, c.N, max(batch, 2), m)[:, :batch].contiguous()
    program = pt.compile_program(c)
    for want_cw in (False, True):
        before = dict(decoder_kernel.launches)
        got = decoder_kernel.decode(program, c.frozen, llr, want_cw)
        want = decoder_kernel.decode_plain(program, c.frozen, llr, want_cw)
        track = "fastssc_decoder_cw" if want_cw else "fastssc_decoder_u"
        assert decoder_kernel.launches[track] == before[track] + 1
        assert torch.equal(got[0], want[0])
        if want_cw:
            assert torch.equal(got[1], want[1])


def test_kernel_decoder_output_modes(dev):
    c = pt.make_code(9, rate=0.25)
    llr = _llrs(dev, c.N, 777, 3).t().contiguous()       # (B, N)
    for mode in ("u", "systematic", "codeword", "both"):
        got = make_kernel_decoder(c, output=mode)(llr)
        want = pt.make_fastssc_decoder(c, output=mode, output_dtype=torch.int8)(llr)
        for a, b in zip(*((got, want) if mode == "both" else ((got,), (want,)))):
            assert torch.equal(a, b)
    dec, desc = pt.make_auto_decoder(c, device=dev)
    assert desc == "cuda-fastssc"


def test_decoder_rejects_bad_input(dev):
    c = pt.make_code(6, rate=0.5)
    program = pt.compile_program(c)
    with pytest.raises(ValueError):
        decoder_kernel.decode(program, c.frozen,
                              torch.zeros(c.N, 8, dtype=torch.int16, device=dev), False)
    with pytest.raises(ValueError):
        decoder_kernel.decode(program, c.frozen,
                              torch.zeros(8, c.N, dtype=torch.int8, device=dev).t(), False)


@pytest.mark.parametrize("m", [3, 8, 10])
@pytest.mark.parametrize("systematic", [True, False])
def test_step_kernel_inject_matches_plain(dev, m, systematic):
    c = pt.make_code(m, rate=0.5)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    batch = 1000
    msg = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                 device=dev)).to(torch.int8)
    nrm = torch.randn((c.N, batch), generator=g, device=dev)
    args = (pt.compile_program(c), c.frozen, snr_params(0.0), systematic)
    got = step_kernel.step(*args, msg_t=msg, normals_t=nrm)
    assert torch.equal(got, step_kernel.step_plain(*args, msg_t=msg, normals_t=nrm))
    assert int(got[3]) > 0


def test_step_kernel_native_matches_plain_bits(dev):
    c = pt.make_code(8, rate=0.5)
    args = (pt.compile_program(c), c.frozen, snr_params(1.0), True)
    kw = dict(seeds=(77, 78), call=5, batch=3000, device=dev)
    a = step_kernel.step(*args, **kw)
    assert torch.equal(a, step_kernel.step(*args, **kw))
    b = step_kernel.step_plain(*args, **kw)
    # identical Philox words; an ulp of log/sqrt may move an LLR (see
    # chip_smoke.py phase 4): at most 3 frames' worth of bits apart
    assert int((a - b).abs().max()) <= 3 * c.K


def test_campaign_runs_through_the_kernels(dev):
    c = pt.make_code(7, rate=0.5)
    for counts in (decoder_kernel.launches, step_kernel.launches):
        for k in counts:
            counts[k] = 0
    res = pt.run_campaign(c, device=dev, batch=4096, max_frames_per_point=8192,
                          snr_range=(0.0, 2.0), snr_step=1.0)
    assert len(res.points) == 3 and res.points[0].bit_errors > 0
    assert step_kernel.launches["mc_step"] > 0
    assert decoder_kernel.launches["fastssc_decoder_cw"] > 0
    assert np.isfinite(res.peak_mbps) and res.peak_mbps > 0
