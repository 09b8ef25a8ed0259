"""The plain reference against the upstream test bench's golden vectors,
and against the program's plain chain on the CPU at small sizes."""

import numpy as np
import pytest
import torch
from conftest import REPO

from reference import construction, polar

VEC = REPO / "tests" / "vectors" / "golden.npz"


def _configs():
    with np.load(VEC) as z:
        return sorted({tuple(int(x) for x in k.split("_")[1:])
                       for k in z if k.startswith("mask_")})


@pytest.fixture(scope="module")
def vectors():
    with np.load(VEC) as z:
        return dict(z.items())


@pytest.mark.parametrize("m,rk", [c for c in _configs() if c[0] <= 11])
def test_golden(vectors, m, rk):
    mask = construction.frozen_mask(m, int(rk / 100 * (1 << m)))
    np.testing.assert_array_equal(mask, vectors[f"mask_{m}_{rk}"])
    code = polar.Code(mask, "cpu")
    msg = torch.as_tensor(vectors[f"enc_msg_{m}_{rk}"]).t()
    u = torch.ones((code.n, msg.shape[1]), dtype=torch.int8)
    u[code.info] = msg
    cw = polar.encode_systematic(code.frozen_t, u).t().numpy()
    np.testing.assert_array_equal(cw, vectors[f"enc_sys_{m}_{rk}"])
    i = 0
    while f"llr_{m}_{rk}_{i}" in vectors:
        llr = torch.as_tensor(vectors[f"llr_{m}_{rk}_{i}"])
        np.testing.assert_array_equal(code.decode_frames(llr, 7).numpy(),
                                      vectors[f"dec_{m}_{rk}_{i}"])
        i += 1
    assert i


@pytest.mark.parametrize("level,batch,snr", [(6, 40, -1.0), (8, 24, 0.5)])
def test_step_counters_equal_the_programs_plain_step(level, batch, snr):
    import polar_tpu_torch as pt
    from polar_tpu_torch.ops.cuda import philox, step_kernel

    k = 1 << (level - 1)
    code = pt.make_code(level, k)
    ref = polar.Code(construction.frozen_mask(level, k), "cpu")
    np.testing.assert_array_equal(ref.frozen, code.frozen)
    for key in [(1, 2), (0xDEADBEEF, 0x12345678)]:
        want = step_kernel.step_plain(
            pt.compile_program(code), code.frozen, pt.channel.snr_params(snr),
            True, seeds=key, call=0, batch=batch, device="cpu")
        got = ref.step_counters(key, snr, batch, chunk=7)
        assert got == want.tolist()
        w = polar.words(key, range(batch), 0, 2 * ref.n, "cpu")
        np.testing.assert_array_equal(
            w.numpy(), philox.random_bits(key, 0, 2 * ref.n, batch,
                                          "cpu").numpy())


def test_decode_equals_the_programs_eager_decoder():
    import polar_tpu_torch as pt

    code = pt.make_code(9, 256)
    ref = polar.Code(construction.frozen_mask(9, 256), "cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    llr = torch.randint(-128, 128, (64, 512), generator=gen,
                        dtype=torch.int8)
    want = pt.make_fastssc_decoder(code, output_dtype=torch.int8)(llr)
    np.testing.assert_array_equal(ref.decode_frames(llr, 17).numpy(),
                                  want.numpy())


def test_channel_batches_are_the_seeds():
    ref = polar.Code(construction.frozen_mask(7, 64), "cpu")
    a, b = (ref.channel_batches(torch.Generator().manual_seed(s), -1.0, 2,
                                32) for s in (3, 3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (32, 128) and a[0].dtype == torch.int8
    assert not torch.equal(a[0], a[1])


def test_the_control_precision_decodes_otherwise():
    ref8 = polar.Code(construction.frozen_mask(8, 128), "cpu")
    ref4 = polar.Code(construction.frozen_mask(8, 128), "cpu", bits=4)
    gen = torch.Generator().manual_seed(9)
    llr = ref8.channel_batches(gen, -1.0, 1, 256)[0]
    assert (ref4.decode_frames(llr, 64) != ref8.decode_frames(llr, 64)).any()
