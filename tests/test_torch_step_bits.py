"""The fused step's bits mode (``step_kernel.step_plain(words_t=...)``) on
the CPU.

* Against the JAX package's Pallas step in bits mode
  (``make_pallas_step(prng="bits")`` in interpret mode) on the words its
  ``step_bits`` draws, ``jax.random.bits(key, (2N, B), uint32)``, stored as
  int32: the counters are equal in both modes at m = 4..8, B = 128. They
  could differ only where the Pallas chain's ``cw + σ·n``, which XLA:CPU
  contracts into one rounding under jit, and the port's two roundings give
  different LLRs, all within two float32 ulps of a quantization half-step
  (``tests/test_torch_tile_step.py``). The test counts those frames and pins
  the count: on these words there are none.
* Bits mode on the words native mode draws counts what native mode counts,
  and on CPU tensors the wrapper runs the plain version.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.step_kernel import _snr_params, make_pallas_step
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import philox, step_kernel

BATCH = 128
SNR_DB = 0.5
# (m, systematic) -> frames with an LLR within two float32 ulps of a
# half-step on the test's words, where the two roundings could part
NEAR_HALF_FRAMES = {(m, s): 0 for m in range(4, 9) for s in (True, False)}


def _near_half_frames(code, systematic, words, params):
    msg, nrm = step_kernel._words_plain(words)
    _, cw, _, _ = step_kernel._front_plain(code.frozen, params, systematic,
                                           msg, nrm, None, 0, 0, None)
    sigma, scale = (np.float32(p) for p in params)
    q = scale * (cw.numpy().astype(np.float32) + sigma * nrm.numpy())
    near = np.abs(q - np.floor(q) - 0.5) <= 2 * np.spacing(np.abs(q))
    return int(near.any(axis=0).sum())


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("m", [4, 5, 6, 7, 8])
def test_bits_step_matches_pallas_bits_step(m, systematic):
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    params = tuple(float(x) for x in np.asarray(_snr_params(SNR_DB)))
    assert params == snr_params(SNR_DB)
    step = make_pallas_step(jc, prng="bits", interpret=True, frame_tile=128,
                            systematic=systematic)
    key = jax.random.PRNGKey(1000 * m + systematic)
    want = {k: int(v) for k, v in step(key, SNR_DB, BATCH).items()}
    bits = np.asarray(jax.random.bits(key, (2 * code.N, BATCH), jnp.uint32))
    words = torch.from_numpy(bits.view(np.int32).copy())
    assert _near_half_frames(code, systematic, words, params) == \
        NEAR_HALF_FRAMES[(m, systematic)]
    got = step_kernel.step_plain(pt.compile_program(code), code.frozen,
                                 params, systematic, words_t=words)
    assert dict(zip(step_kernel.COUNTERS, got.tolist())) == want
    assert want["awgn_errors"] > 0


@pytest.mark.parametrize("systematic", [True, False])
def test_bits_mode_counts_what_native_mode_counts(systematic):
    """On the (2N, B) words native mode draws (rows [0, N) the normals',
    [N, 2N) the message's), both styles, at levels of the tile step and
    the walk."""
    for m, batch in ((2, 33), (6, 64), (9, 40)):
        code = pt.make_code(m, rate=0.5)
        args = (pt.compile_program(code), code.frozen, snr_params(-1.0),
                systematic)
        kw = dict(seeds=(m, 9), call=4, batch=batch, device="cpu")
        words = philox.to_int32(philox.random_bits((m, 9), 4, 2 * code.N,
                                                   batch, "cpu"))
        native = step_kernel.step(*args, **kw)
        before = dict(step_kernel.launches)
        for style in step_kernel.STEP_STYLES:
            assert torch.equal(step_kernel.step(*args, words_t=words,
                                                style=style), native)
        assert step_kernel.launches == before
        assert int(native[3]) > 0


def test_to_int32_keeps_the_bits():
    w = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    got = philox.to_int32(w)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    assert ((got.to(torch.int64) & 0xFFFFFFFF) == w).all()


def test_bits_words_are_checked():
    code = pt.make_code(5, rate=0.5)
    dev = torch.device("cuda")     # the checks run before any launch
    for bad in (torch.zeros((2 * code.N, 8), dtype=torch.int64),
                torch.zeros((code.N, 8), dtype=torch.int32),
                torch.zeros((2 * code.N, 8), dtype=torch.int32)):
        with pytest.raises(ValueError, match="words_t"):
            step_kernel._check_draws(code.frozen, None, None, None, 0, dev,
                                     bad)
