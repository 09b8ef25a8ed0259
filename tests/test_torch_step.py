"""The fused Monte-Carlo step's plain version against polar_tpu (exact on
injected inputs), and its Philox generator against Random123's known
answers.

Exactness strategy as in ``tests/test_step_kernel.py``: inject mode feeds
the same message symbols and normals (numpy, from a seed) to the port's
eager chain, to the Pallas step kernel in interpret mode and to the JAX
XLA chain; every counter must match. The JAX package's (σ, 2/σ²) is fed
to the port, and a separate test compares the port's own computation of
them. Native mode draws Philox words the TPU cannot reproduce, so it is
checked in distribution.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.decode.fastssc import make_fastssc_decoder as j_fastssc
from polar_tpu.ops.pallas.step_kernel import (_bits_to_normals, _bits_to_sym,
                                              _snr_params, make_pallas_step)
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import philox, step_kernel

KAT = [  # (counter, key, output) from Random123's kat_vectors, philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _jax_params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


def _inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    msg = (1 - 2 * rng.integers(0, 2, (n, batch))).astype(np.int8)
    return msg, rng.standard_normal((n, batch), np.float32)


def _port_counters(code, msg, nrm, snr_db, systematic):
    t = step_kernel.step_plain(pt.compile_program(code), code.frozen,
                               _jax_params(snr_db), systematic,
                               msg_t=torch.from_numpy(msg),
                               normals_t=torch.from_numpy(nrm))
    return dict(zip(step_kernel.COUNTERS, t.tolist()))


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    words = philox.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                                   for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def test_random_bits_layout():
    bits = philox.random_bits((5, 6), 7, 16, 3, "cpu")
    assert bits.shape == (16, 3) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
    # word w of frame f is lane w % 4 of block (f, w // 4, call, 0)
    lanes = philox.philox4x32_10(*(torch.tensor([c]) for c in (2, 3, 7, 0)), (5, 6))
    assert [int(bits[12 + j, 2]) for j in range(4)] == [int(x) for x in lanes]


@pytest.mark.parametrize("m", [5, 6])
@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("snr_db", [-2.0, 1.0])
def test_inject_matches_pallas_step_interpret(m, systematic, snr_db):
    jc = jpt.make_code(m, rate=0.5)
    msg, nrm = _inputs(jc.N, 256, m * 7 + int(snr_db) + systematic)
    step = make_pallas_step(jc, frame_tile=128, interpret=True, prng="inject",
                            systematic=systematic)
    want = {k: int(v) for k, v in
            step(jnp.asarray(msg), jnp.asarray(nrm), snr_db).items()}
    got = _port_counters(pt.code_from_jax(jc), msg, nrm, snr_db, systematic)
    assert got == want
    if snr_db < 0:
        assert got["awgn_errors"] > 0


@functools.lru_cache(maxsize=None)
def _xla_decoder(jc, systematic):
    return jax.jit(j_fastssc(jc, output="systematic" if systematic else "u",
                             output_dtype=jnp.int8))


def _xla_chain_counters(jc, msg_t, normals_t, snr_db, systematic):
    """The JAX XLA chain on identical inputs (the form of
    ``tests/test_step_kernel.py:_reference_counters``)."""
    message = jnp.asarray(msg_t).T[:, jc.info_indices]
    enc = jpt.encode_systematic if systematic else jpt.encode
    codeword = enc(jc, message)
    sigma2 = 0.5 * 10.0 ** (-jnp.float32(snr_db) / 10.0)
    y = codeword.astype(jnp.float32) + jnp.sqrt(sigma2) * jnp.asarray(normals_t).T
    llrs = jnp.clip(jnp.rint((2.0 / sigma2) * y), -128, 127).astype(jnp.int8)
    decoded = _xla_decoder(jc, systematic)(llrs)
    zero_d = decoded == 0
    errs = zero_d | ((decoded < 0) != (message < 0))
    return {
        "uncorrected_errors": int(jnp.sum(errs)),
        "frame_errors": int(jnp.sum(jnp.any(errs, axis=-1))),
        "ambiguity_erasures": int(jnp.sum(zero_d)),
        "awgn_errors": int(jnp.sum((llrs != 0) & ((llrs < 0) != (codeword < 0)))),
        "quantization_erasures": int(jnp.sum(llrs == 0)),
    }


@pytest.mark.parametrize("systematic", [True, False])
def test_m10_counters_match_xla_chain(systematic):
    jc = jpt.make_code(10, rate=0.5)
    msg, nrm = _inputs(jc.N, 256, 10 + systematic)
    for snr_db in (-1.0, 0.5):
        want = _xla_chain_counters(jc, msg, nrm, snr_db, systematic)
        got = _port_counters(pt.code_from_jax(jc), msg, nrm, snr_db, systematic)
        assert got == want, snr_db
    assert want["awgn_errors"] > 0


@pytest.mark.parametrize("snr_db", [-3.0, -1.0, 0.0, 1.2, 2.5, 6.0, 20.0])
def test_port_snr_params_against_jax(snr_db):
    """The port computes (σ, 2/σ²) in torch float32; XLA's pow may round
    differently, so allow at most one float32 ulp."""
    got = np.asarray(snr_params(snr_db), np.float32)
    want = np.asarray(_snr_params(snr_db), np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_bit_maps_range_and_moments():
    bits = philox.random_bits((123, 456), 1, 1024, 256, "cpu")   # 2^18 words
    u = philox.bits_to_unit(bits)
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    # never 0, so log(u) is finite; the top 2^8 words round to exactly 1.0
    edge = philox.bits_to_unit(torch.tensor([0, 2**32 - 257, 2**32 - 256,
                                             2**32 - 1]))
    assert edge.tolist() == [2.0**-25, 1.0 - 2.0**-23, 1.0, 1.0]
    assert abs(float(u.mean()) - 0.5) < 5 / np.sqrt(12 * u.numel())
    z = philox.bits_to_normals(bits)
    assert z.shape == bits.shape and z.dtype == torch.float32
    assert bool(torch.isfinite(z).all())
    # mean within 5 standard errors; variance within 5 standard errors of 1
    assert abs(float(z.mean())) < 5 / np.sqrt(z.numel())
    assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2 / z.numel())
    s = philox.bits_to_sym(bits)
    assert set(s.unique().tolist()) == {-1, 1}
    assert abs(float(s.float().mean())) < 5 / np.sqrt(s.numel())


def test_bit_maps_match_jax():
    bits = philox.random_bits((9, 10), 3, 256, 64, "cpu")
    jbits = jnp.asarray(bits.numpy().astype(np.uint32))
    np.testing.assert_array_equal(philox.bits_to_sym(bits).numpy(),
                                  np.asarray(_bits_to_sym(jbits)).astype(np.int8))
    # the same map; log may differ by an ulp between XLA and torch
    np.testing.assert_allclose(philox.bits_to_normals(bits).numpy(),
                               np.asarray(_bits_to_normals(jbits)),
                               rtol=2e-6, atol=2e-6)


def test_native_plain_on_cpu_is_deterministic_and_quiet():
    c = pt.make_code(6, rate=0.5)
    args = (pt.compile_program(c), c.frozen)
    before = dict(step_kernel.launches)
    kw = dict(seeds=(3, 4), call=1, batch=300, device="cpu")
    loud = step_kernel.step(*args, snr_params(-1.0), True, **kw)
    assert torch.equal(loud, step_kernel.step(*args, snr_params(-1.0), True, **kw))
    assert int(loud[3]) > 0
    kw["call"] = 2
    assert not torch.equal(loud, step_kernel.step(*args, snr_params(-1.0), True, **kw))
    quiet = step_kernel.step(*args, snr_params(20.0), False, **kw)
    assert quiet.tolist() == [0, 0, 0, 0, 0]
    assert step_kernel.launches == before

