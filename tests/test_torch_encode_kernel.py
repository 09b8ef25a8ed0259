"""The port's block encoder against polar_tpu's, bit for bit, on the CPU
(its plain version; the CUDA kernel is held against it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

The JAX encoder runs in interpret mode, as its own tests run it
(``tests/test_encode_kernel.py``), on the same numpy messages; the grid
of (m, rate, block level) is that test's, plus whole-code blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.encode_kernel import make_pallas_encoder
from polar_tpu_torch.ops.cuda import encode_kernel


def _msg(k, batch, seed):
    rng = np.random.default_rng(seed)
    return (1 - 2 * rng.integers(0, 2, (batch, k))).astype(np.int8)


@pytest.mark.parametrize("m,rate,block_level", [
    (7, 0.5, 7),     # whole-block: one kernel, no top stages
    (9, 0.5, 7),     # 4 blocks + 2 top stages
    (10, 0.25, 8),   # low rate: all-frozen-heavy blocks
    (8, 0.75, 6),    # high rate: all-info blocks
    (6, 0.5, None),  # the default level cut to the code's: the whole code
])
@pytest.mark.parametrize("systematic", [True, False])
def test_encoder_matches_pallas_and_xla(m, rate, block_level, systematic):
    jc = jpt.make_code(m, rate=rate)
    msg = _msg(jc.K, 128, seed=m)
    want = jax.jit(make_pallas_encoder(
        jc, systematic=systematic, frame_tile=128, block_level=block_level or m,
        interpret=True))(jnp.asarray(msg))
    code = pt.code_from_jax(jc)
    got = encode_kernel.make_encoder(code, systematic=systematic,
                                     block_level=block_level)(torch.from_numpy(msg))
    assert got.dtype == torch.int8 and got.shape == (128, code.N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = (pt.encode_systematic if systematic else pt.encode)(
        code, torch.from_numpy(msg))
    assert torch.equal(got, ref)


def test_encoder_systematic_property():
    """Info bits appear verbatim at the non-frozen codeword positions
    (testbench.cc:143-146), at every block level."""
    code = pt.make_code(8, rate=0.5)
    msg = torch.from_numpy(_msg(code.K, 77, seed=42))    # any batch
    info = torch.as_tensor(code.info_indices)
    for bl in range(1, 9):
        cw = encode_kernel.make_encoder(code, block_level=bl)(msg)
        assert torch.equal(cw[:, info], msg), bl


def test_encoder_small_codes_and_limits():
    for m in (1, 2):
        code = pt.make_code(m, rate=0.5)
        msg = torch.from_numpy(_msg(code.K, 5, seed=m))
        for systematic in (True, False):
            want = (pt.encode_systematic if systematic else pt.encode)(code, msg)
            got = encode_kernel.make_encoder(code, systematic=systematic)(msg)
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="block level"):
        encode_kernel.make_encoder(pt.make_code(4, rate=0.5), block_level=0)
    with pytest.raises(ValueError, match="block level"):
        encode_kernel.make_encoder(pt.make_code(18, rate=0.5), block_level=18)
    with pytest.raises(ValueError, match="no encoder kernel"):
        encode_kernel.make_encoder(pt.make_code(4, rate=0.5))(
            torch.ones(2, 8, dtype=torch.int8, device="meta"))
