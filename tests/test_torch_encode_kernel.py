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
from polar_tpu_torch.encode import _scatter_message
from polar_tpu_torch.ops.cuda import encode_kernel
from polar_tpu_torch.ops.transform import polar_transform_stages


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


# -- the bits style's layout, emulated in numpy from the wrapper's own host
# tables (encode_kernel.bit_layout, bit_tables): pack, word butterfly,
# refreeze, butterfly, unpack, with the stages in the kernel's order


def _word_stage(v, d):
    """words w with bit d clear ^= word w + d, over the last axis"""
    shape = v.shape
    v = v.reshape(*shape[:-1], shape[-1] // (2 * d), 2, d)
    v[..., 0, :] ^= v[..., 1, :]
    return v.reshape(shape)


def _bit_butterfly(v, blk):
    u, words, threads, regs = encode_kernel.bit_layout(blk)
    for h in (1, 2, 4, 8, 16):                    # rows inside a word
        if h < u:
            mask = np.uint32(sum(1 << j for j in range(32) if not j & h))
            v = v ^ ((v >> np.uint32(h)) & mask)
    d = 1
    while d < min(threads, 32):                   # across lanes
        v, d = _word_stage(v, d), 2 * d
    d = 1
    while d < regs:                               # across registers
        v, d = _word_stage(v, d * threads), 2 * d
    d = 32
    while d < threads:                            # across warps
        v, d = _word_stage(v, d), 2 * d
    return v


def _emulate_bits(code, msg, systematic, blk):
    """The bits-style encoder in numpy: (B, K) ±1 int8 → (B, N) int8."""
    n, batch = code.N, msg.shape[0]
    u, words, _, _ = encode_kernel.bit_layout(blk)
    imask, kfirst = encode_kernel.bit_tables(code, blk)
    shifts = np.arange(u, dtype=np.uint32)
    if blk == n:
        # the scatter: the message row as a bit stream of 32-bit words (two
        # spare words), each word's run taken at its first message symbol
        # by a funnel shift and deposited at its mask's set bits
        k = msg.shape[1]
        pad = np.zeros((batch, 32 * (-(-k // 32) + 2)), bool)
        pad[:, :k] = msg < 0
        stream = (pad.reshape(batch, -1, 32).astype(np.uint64)
                  << np.arange(32, dtype=np.uint64)).sum(axis=2)
        v = np.zeros((batch, n // u), np.uint32)
        for w, mk in enumerate(imask):
            s0, cnt = int(kfirst[w]), bin(int(mk)).count("1")
            run = ((stream[:, (s0 >> 5) + 1] << np.uint64(32))
                   | stream[:, s0 >> 5]) >> np.uint64(s0 & 31)
            run &= np.uint64((1 << cnt) - 1)
            for j in (j for j in range(u) if int(mk) >> j & 1):
                v[:, w] |= (run & np.uint64(1)).astype(np.uint32) << np.uint32(j)
                run >>= np.uint64(1)
    else:
        x = polar_transform_stages(_scatter_message(
            code, torch.from_numpy(msg)), blk, n).numpy()
        v = ((x < 0).reshape(batch, n // u, u).astype(np.uint32)
             << shifts).sum(axis=2, dtype=np.uint32)
    v = _bit_butterfly(v.reshape(batch, n // blk, words), blk)
    if systematic:
        v = _bit_butterfly(v & imask.reshape(n // blk, words), blk)
    bits = (v.reshape(batch, n // u)[..., None] >> shifts) & 1
    out = (1 - 2 * bits.astype(np.int8)).reshape(batch, n)
    if systematic and blk < n:
        out = polar_transform_stages(torch.from_numpy(out), blk, n).numpy()
    return out


def _levels(m):
    return sorted({1, 2, 5, 6, m // 2, m - 1, m} & set(range(1, m + 1)))


@pytest.mark.parametrize("m", range(1, 15))
def test_bit_layout_emulation_matches_encode(m):
    code = pt.make_code(m, rate=0.5)
    msg = _msg(code.K, 6, seed=100 + m)
    for systematic in (True, False):
        want = (pt.encode_systematic if systematic else pt.encode)(
            code, torch.from_numpy(msg)).numpy()
        for bl in _levels(m):
            got = _emulate_bits(code, msg, systematic, 1 << bl)
            np.testing.assert_array_equal(got, want, err_msg=f"level {bl}")
            plain = encode_kernel.encode_plain(
                code, torch.from_numpy(msg), systematic, 1 << bl)
            np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("m", [4, 10, 14])
def test_bit_layout_emulation_matches_jax_encode(m):
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    msg = _msg(code.K, 5, seed=200 + m)
    for systematic in (True, False):
        want = np.asarray((jpt.encode_systematic if systematic else jpt.encode)(
            jc, jnp.asarray(msg)))
        for bl in sorted({m, max(1, m - 4)}):
            np.testing.assert_array_equal(
                _emulate_bits(code, msg, systematic, 1 << bl), want)


def test_bit_tables_and_layout():
    code = pt.make_code(7, rate=0.5)
    imask, kfirst = encode_kernel.bit_tables(code, 1 << 7)
    info = np.flatnonzero(~np.asarray(code.frozen, bool))
    assert imask.dtype == np.uint32 and kfirst.dtype == np.int32
    assert [bin(int(x)).count("1") for x in imask] == [
        int(np.sum((info >= 32 * w) & (info < 32 * w + 32))) for w in range(4)]
    assert list(kfirst) == [int(np.sum(info < 32 * w)) for w in range(4)]
    # a block below 32 rows is one word of its own rows
    imask4, kfirst4 = encode_kernel.bit_tables(code, 4)
    assert len(imask4) == 32 and int(imask4.max()) < 16
    assert encode_kernel.bit_layout(2) == (2, 1, 1, 1)
    assert encode_kernel.bit_layout(1 << 10) == (32, 32, 32, 1)
    assert encode_kernel.bit_layout(1 << 17) == (32, 4096, 256, 16)
    with pytest.raises(TypeError, match="style"):   # one kernel, no style
        encode_kernel.make_encoder(code, style=None)


def _deposit_parallel_suffix(x, m):
    """``encode.cu:deposit`` written out on uint32 numpy arrays."""
    u32 = np.uint32
    m0, mk, mv = m, ~m << u32(1), []
    for i in range(5):
        mp = mk ^ (mk << u32(1))
        for sh in (2, 4, 8, 16):
            mp ^= mp << u32(sh)
        mv.append(mp & m)
        m = (m ^ mv[i]) | (mv[i] >> u32(1 << i))
        mk &= ~mp
    for i in range(4, -1, -1):
        x = (x & ~mv[i]) | ((x << u32(1 << i)) & mv[i])
    return np.where(m0 == u32(0xFFFFFFFF), x, x & m0)


def test_kernel_deposit_places_the_run_at_the_mask():
    """The kernel's branch-free deposit equals a loop over the set bits,
    on the masks of real codes and on random ones."""
    rng = np.random.default_rng(5)
    masks = [encode_kernel.bit_tables(pt.make_code(m, rate=r), 1 << m)[0]
             for m in (10, 14) for r in (0.25, 0.5, 0.75)]
    masks.append(rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32))
    masks.append((rng.integers(0, 2**32, 4096, dtype=np.uint64)
                  & rng.integers(0, 2**32, 4096, dtype=np.uint64)).astype(np.uint32))
    m = np.concatenate(masks)
    x = rng.integers(0, 2**32, m.size, dtype=np.uint64).astype(np.uint32)
    want = np.zeros_like(m)
    mm, xx = m.copy(), x.copy()
    for _ in range(32):       # the set bits of m in order, from the low end
        low = mm & (~mm + np.uint32(1))
        want |= np.where(xx & np.uint32(1), low, np.uint32(0))
        xx = np.where(low != 0, xx >> np.uint32(1), xx)
        mm &= mm - np.uint32(1)
    np.testing.assert_array_equal(_deposit_parallel_suffix(x, m), want)
