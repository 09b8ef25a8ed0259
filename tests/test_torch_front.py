"""The port's block front and counter epilogue against polar_tpu, bit for
bit, on the CPU (their plain versions; the CUDA kernels are held against
these on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Inputs are made with numpy from a seed. The JAX package's (σ, 2/σ²) is
fed to the port, as in ``tests/test_torch_step.py``; its Pallas kernels
run in interpret mode, as its own tests run them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.step_kernel import (_snr_params, make_pallas_count,
                                              make_pallas_front_blocks)
from polar_tpu_torch import ber
from polar_tpu_torch.decode import auto as decode_auto
from polar_tpu_torch.ops.cuda import count_kernel, front_kernel, philox


def _jax_params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("bl,cbl", [(6, 6), (6, 5), (4, 7)])
def test_front_blocks_inject_matches_jax(bl, cbl, systematic):
    jc = jpt.make_code(9, rate=0.5)
    rng = np.random.default_rng(bl * 10 + cbl)
    msg = (1 - 2 * rng.integers(0, 2, (jc.N, 128))).astype(np.int8)
    nrm = rng.standard_normal((jc.N, 128), np.float32)
    snr = -1.0
    jfront = make_pallas_front_blocks(
        jc, frame_tile=128, block_level=bl, chan_block_level=cbl,
        interpret=True, prng="inject", systematic=systematic, middle_mode="xla")
    want = jax.jit(jfront, static_argnums=2)(jnp.asarray(msg), jnp.asarray(nrm), snr)
    got = front_kernel.front_blocks(
        pt.code_from_jax(jc).frozen, _jax_params(snr), systematic,
        msg_t=torch.from_numpy(msg), normals_t=torch.from_numpy(nrm),
        block_level=bl, chan_block_level=cbl)
    assert len(got) == len(want) == (2 if systematic else 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((got[0] == 0).sum()) > 0


def test_count_plain_matches_pallas_count():
    """Zero LLRs, decoded zeros (ties) and saturated values included."""
    jc = jpt.make_code(8, rate=0.5)
    rng = np.random.default_rng(23)
    batch = 256
    llr = rng.integers(-128, 128, (jc.N, batch)).astype(np.int8)
    llr[::7, :] = 0
    cw = np.asarray(jpt.encode_systematic(jc, jnp.asarray(
        (1 - 2 * rng.integers(0, 2, (batch, jc.K))).astype(np.int8)))).T.copy()
    hat = cw.copy()
    hat[rng.integers(0, 50, hat.shape) == 0] = 0
    flip = rng.integers(0, 50, hat.shape) == 0
    hat[flip] = -hat[flip]
    want = make_pallas_count(jc, frame_tile=128, interpret=True)(
        jnp.asarray(llr), jnp.asarray(cw), jnp.asarray(hat))
    got = count_kernel.count(jc.frozen, *(torch.from_numpy(x)
                                          for x in (llr, cw, hat)))
    from polar_tpu_torch.ops.cuda.step_kernel import COUNTERS

    assert dict(zip(COUNTERS, got.tolist())) == {k: int(v) for k, v in want.items()}
    assert 0 < int(got[1]) < batch and int(got[2]) > 0 and int(got[4]) > 0


def test_random_bits_word_offset():
    full = philox.random_bits((7, 8), 2, 64, 5, "cpu")
    np.testing.assert_array_equal(
        philox.random_bits((7, 8), 2, 24, 5, "cpu", first=32).numpy(),
        full[32:56].numpy())
    with pytest.raises(ValueError):
        philox.random_bits((7, 8), 2, 8, 5, "cpu", first=2)


def test_front_native_draws_the_fused_step_words():
    """Kernel A's symbols are words N + r of each frame's stream; kernel
    B's normals are the Box-Muller map of words [0, N), as the fused
    step's plain chain draws them."""
    c = pt.make_code(7, rate=0.5)
    kw = dict(seeds=(3, 9), call=4)
    u0 = front_kernel.msg_blocks(c.frozen, 16, False, batch=33, device="cpu", **kw)
    bits = philox.random_bits((3, 9), 4, 2 * c.N, 33, "cpu")
    sym = philox.bits_to_sym(bits[c.N:])
    frz = torch.from_numpy(c.frozen.astype(bool)).reshape(-1, 1)
    assert torch.equal(u0, torch.where(frz, torch.ones_like(sym), sym))
    llr, cw = front_kernel.chan_blocks(u0, 8, pt.channel.snr_params(0.0), **kw)
    llr_i, cw_i = front_kernel.chan_blocks(
        u0, 8, pt.channel.snr_params(0.0),
        normals_t=philox.bits_to_normals(bits[:c.N]))
    assert torch.equal(llr, llr_i) and torch.equal(cw, cw_i)


def test_front_decode_cfg_raises_when_not_consumed(monkeypatch):
    c = pt.make_code(9, rate=0.5)
    with pytest.raises(ValueError, match="front_decode_cfg"):
        ber.make_step(c, front_decode_cfg=5, device="cpu")       # fused step
    with pytest.raises(ValueError, match="front_decode_cfg"):
        ber.make_step(c, fused=False, front_decode_cfg=5, device="cpu")
    with pytest.raises(ValueError, match="front_decode_cfg"):
        pt.run_campaign(c, front_decode_cfg=5, device="cpu", batch=8,
                        max_frames_per_point=8, snr_range=(0.0, 0.0),
                        measure_throughput=False)
    monkeypatch.setattr(ber, "STEP_KERNEL_MAX_LEVEL", 8)
    with pytest.raises(ValueError, match="front_decode_cfg"):
        ber.make_step(c, compute="int8", front_decode_cfg=5, device="cpu")
    with pytest.raises(ValueError, match="front_decode_cfg"):
        ber.make_step(c, front_decode_cfg=5, device="cpu")     # whole front
    # the front path's hybrid branch consumes it
    monkeypatch.setattr(ber, "FRONT_WHOLE_MAX_LEVEL", 0)
    monkeypatch.setattr(decode_auto, "HYBRID_MIN_LEVEL", 9)
    step = ber.make_step(c, front_decode_cfg=5, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    assert set(step(gen, 0.0, 16)) == set(count_kernel.COUNTERS)
