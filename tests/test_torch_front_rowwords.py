"""The index math of the block front's row-word kernels (kernels A and B,
``csrc/front.cu`` ``front_msg_rows_kernel`` / ``front_chan_rows_kernel``)
on the CPU, where the kernels cannot run: their torch twins in
``ops/cuda/front_kernel.py`` (row words of 32 frames, the XOR butterfly on
them, kernel A's Philox block per four rows with the all-frozen skip,
kernel B's block pairing and its n0 / n1 writes) against the plain
versions, bit for bit, and the inject twins through the whole front
against the JAX package's block front in interpret mode.

Inputs are made with numpy from a seed. The card tests of the kernels
themselves are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.step_kernel import (_snr_params,
                                              make_pallas_front_blocks)
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import build, front_kernel

BATCHES = [1, 31, 33, 999]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The twins run many small torch ops. Beside other test processes on
    the same cores, torch's intra-op threads wait on each other at every
    op, so this module runs on one thread and then restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    msg = (1 - 2 * rng.integers(0, 2, (n, batch))).astype(np.int8)
    return (torch.from_numpy(msg),
            torch.from_numpy(rng.standard_normal((n, batch), np.float32)))


def _blocks(m):
    return [1 << lb for lb in range(m + 1)]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("m", range(1, 13))
def test_msg_rows_twin_matches_plain(m, batch):
    """Kernel A's twin == msg_blocks_plain at every block size, native and
    inject, systematic and plain; a native frame draws one Philox block per
    chunk with an info row and none for an all-frozen chunk."""
    c = pt.make_code(m, rate=0.5)
    msg, _ = _inputs(c.N, batch, 100 * m + batch)
    for blk in _blocks(m):
        for systematic in (True, False):
            for kw in (dict(msg_t=msg),
                       dict(seeds=(5, 6), call=2, batch=batch, device="cpu")):
                got, drawn = front_kernel.msg_rows_twin(c.frozen, blk,
                                                        systematic, **kw)
                want = front_kernel.msg_blocks_plain(c.frozen, blk,
                                                     systematic, **kw)
                assert torch.equal(got, want), (blk, systematic, list(kw))
                if "seeds" in kw:
                    chunks = np.asarray(c.frozen, bool).reshape(
                        -1, min(4, blk))
                    assert drawn == int((~chunks.all(axis=1)).sum())
                    if m >= 5:
                        assert drawn < chunks.shape[0]   # the skip is real


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("m", range(1, 13))
def test_chan_rows_twin_matches_plain(m, batch):
    """Kernel B's twin == chan_blocks_plain at every block size (N/2 < blk
    and N <= 8 included), native and inject: the LLRs and cw."""
    c = pt.make_code(m, rate=0.5)
    y, nrm = _inputs(c.N, batch, 100 * m + batch + 7)
    params = snr_params(-1.0)
    for blk in _blocks(m):
        for kw in (dict(normals_t=nrm), dict(seeds=(5, 6), call=2)):
            got = front_kernel.chan_rows_twin(y, blk, params, **kw)
            want = front_kernel.chan_blocks_plain(y, blk, params, **kw)
            assert torch.equal(got[1], want[1]), (blk, list(kw))
            assert torch.equal(got[0], want[0]), (blk, list(kw))


@pytest.mark.parametrize("m", range(1, 18))
def test_chan_pair_plan_covers_every_row_once(m):
    n = 1 << m
    for blk in _blocks(m):
        plan = front_kernel.chan_pair_plan(n, blk)
        p_rows = min(blk, n // 2)
        assert plan.shape == (n // (2 * p_rows), 2 * p_rows)
        assert torch.equal(plan.reshape(-1).sort().values, torch.arange(n))
        low, high = plan[:, :p_rows], plan[:, p_rows:]
        assert bool((low < n // 2).all()) and torch.equal(high, low + n // 2)
        # every CTA's rows hold whole blk-row blocks, so its XOR stages
        # below blk are the front's bottom stages
        blocks = plan.reshape(-1, min(blk, 2 * p_rows))
        assert bool((blocks[:, 0] % min(blk, n) == 0).all())
        assert bool((blocks.diff(dim=1) == 1).all())


@pytest.mark.parametrize("batch", [1, 31, 33, 64])
def test_row_words_round_trip_and_xor_butterfly(batch):
    """Row words of 32 frames (tail lanes vote 0) go back to the same ±1
    rows, and the XOR stages on words are the ±1 products' stages."""
    x, _ = _inputs(64, batch, batch)
    words = front_kernel.row_words(x)
    assert words.shape == (64, -(-batch // 32))
    assert int(words.max()) < 1 << 32 and int(words.min()) >= 0
    if batch % 32:
        assert int((words[:, -1] >> (batch % 32)).max()) == 0
    assert torch.equal(front_kernel.rows_from_words(words, batch), x)
    for blk in (1, 2, 8, 64):
        got = front_kernel.rows_from_words(
            front_kernel.xor_stages(words, blk), batch)
        want = front_kernel.polar_transform_stages(x, 1, blk, axis=0)
        assert torch.equal(got, want)


def _jax_params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("bl,cbl", [(6, 6), (4, 7), (9, 9)])
def test_inject_twins_match_pallas_front_blocks(bl, cbl, systematic):
    """Kernel A's twin, the plain middle and kernel B's twin, the front as
    the row-word kernels compute it, against the JAX package's block front
    at Polar(512, 256) (``prng="inject"``, ``middle_mode="xla"``)."""
    jc = jpt.make_code(9, rate=0.5)
    msg, nrm = _inputs(jc.N, 128, bl * 10 + cbl)
    snr = -1.0
    jfront = make_pallas_front_blocks(
        jc, frame_tile=128, block_level=bl, chan_block_level=cbl,
        interpret=True, prng="inject", systematic=systematic,
        middle_mode="xla")
    want = jax.jit(jfront, static_argnums=2)(jnp.asarray(msg.numpy()),
                                             jnp.asarray(nrm.numpy()), snr)
    frozen = pt.code_from_jax(jc).frozen
    x, drawn = front_kernel.msg_rows_twin(frozen, 1 << bl, systematic,
                                          msg_t=msg)
    assert drawn == 0
    y = front_kernel.middle_plain(x, frozen, 1 << bl, 1 << cbl, systematic)
    got = front_kernel.chan_rows_twin(y, 1 << cbl, _jax_params(snr),
                                      normals_t=nrm)
    got = got + (() if systematic else (x,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _Asked(Exception):
    pass


@pytest.mark.parametrize("kernel", ["a", "b"])
def test_both_styles_launch_on_their_tensors_device(monkeypatch, kernel):
    """On fake ``cuda:1`` tensors kernels A and B ask ``build.stream`` for
    that device before their launch, as ``tests/test_torch_device.py``
    checks the whole front."""
    asked = []

    def stream(device):
        asked.append(device)
        raise _Asked

    monkeypatch.setattr(build, "stream", stream)
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail(
        "the library was loaded before the device was set"))
    c = pt.make_code(6, rate=0.5)
    dev = torch.device("cuda", 1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((c.N, 40), dtype=torch.int8, device=dev)
        with pytest.raises(_Asked):
            if kernel == "a":
                front_kernel.msg_blocks(c.frozen, 16, True, msg_t=x)
            else:
                front_kernel.chan_blocks(x, 16, (0.5, 8.0), seeds=(1, 2))
    assert [(d.type, d.index) for d in asked] == [("cuda", 1)]


def test_styles_and_the_on_chip_limit_are_checked():
    """The wrappers take no style on any device; on a card the row-word
    kernels refuse a CTA of more than ROWS_MAX_WORDS row words before any
    launch."""
    c = pt.make_code(4, rate=0.5)
    x, _ = _inputs(c.N, 8, 0)
    with pytest.raises(TypeError, match="style"):
        front_kernel.msg_blocks(c.frozen, 4, True, msg_t=x, style=None)
    with pytest.raises(TypeError, match="style"):
        front_kernel.chan_blocks(x, 4, (0.5, 8.0), seeds=(1, 2), style=None)
    with pytest.raises(TypeError, match="front_style"):
        front_kernel.front_blocks(c.frozen, (0.5, 8.0), True, msg_t=x,
                                  normals_t=torch.zeros(c.N, 8),
                                  front_style=None)
    n = 4 * front_kernel.ROWS_MAX_WORDS
    frozen = np.zeros(n, bool)
    with FakeTensorMode(allow_non_fake_inputs=True):
        big = torch.empty((n, 4), dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError, match="lower block level"):
            front_kernel.msg_blocks(frozen, 2 * front_kernel.ROWS_MAX_WORDS,
                                    True, msg_t=big)
        with pytest.raises(ValueError, match="lower block level"):
            front_kernel.chan_blocks(big, front_kernel.ROWS_MAX_WORDS,
                                     (0.5, 8.0), seeds=(1, 2))
    # the largest CTA the kernels take
    assert front_kernel._rows_words(n, front_kernel.ROWS_MAX_WORDS, False) \
        == front_kernel.ROWS_MAX_WORDS
    assert front_kernel._rows_words(n, front_kernel.ROWS_MAX_WORDS // 2,
                                    True) == front_kernel.ROWS_MAX_WORDS
