"""The port's elementwise channel kernels (symbols, AWGN) against
polar_tpu's, on the CPU (their plain versions; the CUDA kernels are held
against these on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Bits mode feeds the same numpy u32 words to the port and to the Pallas
kernels in interpret mode, as the JAX package's own tests run them; the
JAX package's (σ, 2/σ²) is fed to the port, as in
``tests/test_torch_step.py``. Native mode draws Philox words, checked
against the documented word map.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from polar_tpu.ops.pallas.channel_kernel import (make_pallas_awgn,
                                                 make_pallas_symbols,
                                                 pick_blocks)
from polar_tpu.ops.pallas.step_kernel import _snr_params
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import build, channel_kernel, philox


def _jax_params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def test_symbols_bits_match_pallas():
    """The plain version and the lines kernel's twin (its byte map
    0x01 | (w & 1) * 0xFE) on the same words as the Pallas kernel."""
    words = _words(np.random.default_rng(0), (320, 640))
    want = make_pallas_symbols(interpret=True, prng="bits")(jnp.asarray(words))
    got = channel_kernel.symbols(words=_t(words))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {-1, 1}
    twin, drawn = channel_kernel.symbols_lines_twin(None, words=_t(words))
    assert torch.equal(drawn, _t(words))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(32, 512), (33, 1024), (2, 4096)])
def test_symbols_lines_warp_exchange(shape):
    """Bits mode at cols % 512 == 0: the warp's coalesced loads and
    ballots hand every lane the low bits of its own 16 words; the symbols
    equal the plain version's and the Pallas kernel's on the same words."""
    words = _words(np.random.default_rng(sum(shape)), shape)
    twin, drawn = channel_kernel.symbols_lines_twin(None, words=_t(words))
    assert torch.equal(drawn, _t(words) & 1)
    assert torch.equal(twin, channel_kernel.symbols_plain(words=_t(words)))
    if pick_blocks(*shape) is not None:
        want = make_pallas_symbols(interpret=True, prng="bits")(
            jnp.asarray(words))
        np.testing.assert_array_equal(twin.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (63, 70), (3, 100),
                                   (2, 16), (32, 128), (64, 512)])
def test_symbols_lines_index_map(shape):
    """The lines kernel's index map (frame, column group, lane → Philox
    block 4 g + i // 4, lane i % 4, through PhiloxFrame's split first
    round) draws the documented words, and its symbols equal the plain
    version's and, where the Pallas kernel tiles the shape (rows % 32,
    cols % 128), the Pallas kernel's on those words."""
    kw = dict(seeds=(12, 34), call=5)
    twin, drawn = channel_kernel.symbols_lines_twin(shape, **kw)
    assert torch.equal(drawn, philox.frame_words((12, 34), 5, *shape, "cpu"))
    assert torch.equal(twin, channel_kernel.symbols_plain(shape, **kw,
                                                          device="cpu"))
    if pick_blocks(*shape) is not None:
        want = make_pallas_symbols(interpret=True, prng="bits")(
            jnp.asarray(drawn.numpy().astype(np.uint32)))
        np.testing.assert_array_equal(twin.numpy(), np.asarray(want))


def test_philox_frame_equals_philox():
    """PhiloxFrame's split first round and keys made once give
    philox4x32_10's words, for any frame, block and call."""
    rng = np.random.default_rng(8)
    f, b = (torch.from_numpy(rng.integers(0, 2**32, 4096, dtype=np.uint64)
                             .astype(np.int64)) for _ in range(2))
    for call in (0, 7, 2**32 - 1):
        got = channel_kernel.philox_frame_blocks((0xDEADBEEF, 3), call, f, b)
        want = philox.philox4x32_10(f, b, torch.full_like(f, call),
                                    torch.zeros_like(f), (0xDEADBEEF, 3))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("snr_db", [-1.0, 3.0])
def test_awgn_bits_match_pallas(snr_db):
    rng = np.random.default_rng(1 + int(snr_db))
    cw = (1 - 2 * rng.integers(0, 2, (96, 256))).astype(np.int8)
    b1, b2 = _words(rng, cw.shape), _words(rng, cw.shape)
    want = make_pallas_awgn(interpret=True, prng="bits")(
        jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(cw), snr_db)
    got = channel_kernel.awgn(torch.from_numpy(cw), _jax_params(snr_db),
                              words=(_t(b1), _t(b2)))
    assert got.dtype == torch.int8
    # exact equality is the target; torch's and XLA's float32 log may
    # differ by an ulp on some CPUs, which can move an LLR across a
    # rounding boundary: at most 1 in 10^4 positions, by 1
    d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 10**4
    assert np.count_nonzero(got.numpy() == 0) > 0


def test_cosine_box_muller_distribution():
    rng = np.random.default_rng(3)
    b1, b2 = _words(rng, (1 << 9, 512)), _words(rng, (1 << 9, 512))
    n = philox.bits_to_normals_cos(_t(b1), _t(b2)).numpy().ravel()
    assert n.dtype == np.float32 and np.isfinite(n).all()
    assert abs(n.mean()) < 0.01
    assert abs(n.std() - 1.0) < 0.01
    assert 0.001 < np.mean(np.abs(n) > 3.0) < 0.006
    assert abs(np.mean(n**4) - 3.0) < 0.15


def test_native_plain_draws_the_documented_words():
    """Symbol c of frame f is word c of the message stream; the normal of
    element c takes words c and cols + c of the noise stream."""
    rows, cols = 37, 70                     # cols not a multiple of 4
    sym = channel_kernel.symbols((rows, cols), seeds=(5, 6), call=2,
                                 device="cpu")
    w = philox.frame_words((5, 6), 2, rows, cols, "cpu")
    assert torch.equal(sym, philox.bits_to_sym(w))
    cw = 1 - 2 * (sym < 0).to(torch.int8)
    params = snr_params(0.5)
    llr = channel_kernel.awgn(cw, params, seeds=(7, 8), call=2)
    w = philox.frame_words((7, 8), 2, rows, 2 * cols, "cpu")
    assert torch.equal(llr, channel_kernel.awgn(
        cw, params, words=(w[:, :cols], w[:, cols:])))
    # word c of frame f is lane c % 4 of Philox block (f, c // 4, call, 0)
    lanes = philox.philox4x32_10(*(torch.tensor([c]) for c in (3, 5, 2, 0)),
                                 (7, 8))
    assert [int(x) for x in w[3, 20:24]] == [int(x) for x in lanes]


def test_plain_chunks_are_exact(monkeypatch):
    cw = (1 - 2 * (torch.arange(33 * 48).reshape(33, 48) % 3 == 0)).to(torch.int8)
    params = snr_params(-1.0)
    whole_s = channel_kernel.symbols((33, 48), seeds=(1, 2), device="cpu")
    whole_a = channel_kernel.awgn(cw, params, seeds=(3, 4))
    monkeypatch.setattr(channel_kernel, "PLAIN_CHUNK", 100)   # 2 frames
    assert torch.equal(whole_s, channel_kernel.symbols((33, 48), seeds=(1, 2),
                                                       device="cpu"))
    assert torch.equal(whole_a, channel_kernel.awgn(cw, params, seeds=(3, 4)))


def test_frame_words_offsets_and_plain_counts():
    full = philox.frame_words((9, 9), 1, 6, 40, "cpu")
    np.testing.assert_array_equal(
        philox.frame_words((9, 9), 1, 3, 13, "cpu", first=6, frame0=2).numpy(),
        full[2:5, 6:19].numpy())
    before = dict(channel_kernel.plain_calls)
    channel_kernel.symbols((0, 8), seeds=(1, 1), device="cpu")
    assert channel_kernel.plain_calls["symbols_plain"] == before["symbols_plain"] + 1
    assert channel_kernel.launches == {"channel_symbols": 0, "channel_awgn": 0}
    with pytest.raises(ValueError, match="no AWGN kernel"):
        channel_kernel.awgn(torch.zeros(2, 4, dtype=torch.int8, device="meta"),
                            params=(1.0, 2.0), seeds=(1, 2))


@pytest.mark.parametrize("chunk", range(4))
def test_one_polynomial_cosine_equals_sincos_bit_for_bit(chunk):
    """The straight-line AWGN kernel's cosine (one polynomial, picked by
    the quadrant) rounds as ``sincos_2pi``'s cosine on every value that
    ``bits_to_unit`` can produce: all 2^24, in chunks of 2^22."""
    top = torch.arange(chunk << 22, (chunk + 1) << 22, dtype=torch.int64)
    u = philox.bits_to_unit(top << 8)
    got = channel_kernel.cos_2pi_one_poly(u)
    want = philox.sincos_2pi(u)[0]
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_awgn_styles_on_the_cpu():
    """A CPU tensor runs the plain version, counted as a plain run; the
    wrapper has one kernel and takes no style."""
    cw = (1 - 2 * (torch.arange(6 * 32).reshape(6, 32) % 5 == 0)).to(torch.int8)
    params = snr_params(0.0)
    before = channel_kernel.plain_calls["awgn_plain"]
    got = channel_kernel.awgn(cw, params, seeds=(1, 2), call=3)
    assert torch.equal(got, channel_kernel.awgn_plain(cw, params, seeds=(1, 2),
                                                      call=3))
    assert channel_kernel.plain_calls["awgn_plain"] == before + 2
    with pytest.raises(TypeError, match="style"):
        channel_kernel.awgn(cw, params, seeds=(1, 2), style=None)
    assert [c for c in vars(channel_kernel) if c.endswith("launches")] == [
        "launches"]


def test_symbols_styles_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing; the
    wrapper has one kernel and takes no style."""
    kw = dict(seeds=(1, 2), call=3, device="cpu")
    launched = dict(channel_kernel.launches)
    want = channel_kernel.symbols_plain((7, 40), **kw)
    assert torch.equal(want, channel_kernel.symbols((7, 40), **kw))
    with pytest.raises(TypeError, match="style"):
        channel_kernel.symbols((7, 40), **kw, style=None)
    assert channel_kernel.launches == launched


class _Asked(Exception):
    pass


def test_symbols_styles_ask_for_their_tensors_device(monkeypatch):
    """On fake ``cuda:1`` words the symbols wrapper asks ``build.stream``
    for that device before it loads the library."""
    asked = []

    def stream(device):
        asked.append(device)
        raise _Asked

    monkeypatch.setattr(build, "stream", stream)
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail(
        "the library was loaded before the device was set"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        words = torch.empty((8, 32), dtype=torch.int64,
                            device=torch.device("cuda", 1))
        with pytest.raises(_Asked):
            channel_kernel.symbols(words=words)
    assert [(d.type, d.index) for d in asked] == [("cuda", 1)]
