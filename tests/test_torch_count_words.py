"""The index math of the counter kernel (``csrc/count.cu``
``count_rows_kernel``) on the CPU, where the kernel cannot run: its torch
twin in ``ops/cuda/count_kernel.py`` (frame groups of 512, byte words and
their marks, row chunks, per-chunk 32-bit frame-error words, the ragged
lanes' vote and the fold with its int64 sums) against the plain version
and the JAX package's ``make_pallas_count`` in interpret mode, bit for
bit; the grid plan; the wrapper on the CPU.

Inputs are made with numpy from a seed. The card tests of the kernel
itself are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.step_kernel import make_pallas_count
from polar_tpu_torch.ops.cuda import build, count_kernel
from polar_tpu_torch.ops.cuda.step_kernel import COUNTERS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The twin runs many small torch ops. Beside other test processes on
    the same cores, torch's intra-op threads wait on each other at every
    op, so this module runs on one thread and then restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, batch, seed):
    """(llr, cw, hat) int8 numpy: full-range LLRs with about 10 % zeros, ±1
    codewords, estimates with about 1 % zeros and 1 % flipped signs."""
    rng = np.random.default_rng(seed)
    llr = rng.integers(-128, 128, (n, batch)).astype(np.int8)
    llr[rng.random((n, batch)) < 0.1] = 0
    cw = (1 - 2 * rng.integers(0, 2, (n, batch))).astype(np.int8)
    hat = cw.copy()
    u = rng.random((n, batch))
    hat[u < 0.01] = 0
    hat[(u >= 0.01) & (u < 0.02)] *= -1
    return llr, cw, hat


def _chunk_rows(n):
    """Row chunks from one row to the whole code, uneven ones among them."""
    return sorted({1, 7, max(1, n // 5), -(-n // 3), n})


@pytest.mark.parametrize("batch", [128, 384, 1152])
@pytest.mark.parametrize("m", [6, 9, 11])
def test_twin_matches_plain_and_pallas(m, batch):
    """The twin == count_plain == make_pallas_count (interpret mode) at
    every chunking; 1152 frames span three frame groups."""
    c = pt.make_code(m, rate=0.5)
    llr, cw, hat = _inputs(c.N, batch, 10 * m + batch)
    t = [torch.from_numpy(x) for x in (llr, cw, hat)]
    want = count_kernel.count_plain(c.frozen, *t)
    jc = jpt.make_code(m, rate=0.5)
    assert np.array_equal(np.asarray(jc.frozen), c.frozen)
    jax_out = make_pallas_count(jc, frame_tile=128, interpret=True)(
        *(jnp.asarray(x) for x in (llr, cw, hat)))
    assert [int(jax_out[k]) for k in COUNTERS] == want.tolist()
    assert min(want.tolist()) > 0
    for rows in _chunk_rows(c.N):
        got, words = count_kernel.count_rows_twin(c.frozen, *t, rows)
        assert torch.equal(got, want), rows
        assert words.shape == (-(-c.N // rows), -(-batch // 32))


@pytest.mark.parametrize("batch", [1, 31, 33])
@pytest.mark.parametrize("m", [1, 2, 8])
def test_twin_matches_plain_off_the_group(m, batch):
    """Batches that fill no 16-frame lane: the ragged lanes vote no error
    and the last frame word keeps no bit past the batch."""
    c = pt.make_code(m, rate=0.5)
    t = [torch.from_numpy(x) for x in _inputs(c.N, batch, m + batch)]
    want = count_kernel.count_plain(c.frozen, *t)
    for rows in _chunk_rows(c.N):
        got, words = count_kernel.count_rows_twin(c.frozen, *t, rows)
        assert torch.equal(got, want), rows
        tail = batch - 32 * (words.shape[1] - 1)     # frames in the last
        assert int((words[:, -1] >> tail).max()) == 0
    # every frame in error: the words hold exactly the batch's bits
    zero = torch.zeros_like(t[2])
    got, words = count_kernel.count_rows_twin(c.frozen, t[0], t[1], zero, c.N)
    assert int(got[1]) == batch
    assert torch.equal(got, count_kernel.count_plain(c.frozen, t[0], t[1],
                                                     zero))


def test_frame_words_name_the_chunk_of_each_error():
    """A frame's only error lands in the frame word of its row's chunk,
    at bit frame % 32 of word frame // 32; errors at frozen rows do not."""
    c = pt.make_code(10, rate=0.5)
    batch, rows = 1152, 100
    llr, cw, _ = (torch.from_numpy(x) for x in _inputs(c.N, batch, 1))
    info = np.flatnonzero(c.frozen == 0)
    frozen_row = int(np.flatnonzero(c.frozen)[0])
    hat = cw.clone()
    marks = {(int(info[0]), 5), (int(info[-1]), 1151), (int(info[300]), 600)}
    for r, f in marks:
        hat[r, f] *= -1
    hat[frozen_row, :] = 0
    got, words = count_kernel.count_rows_twin(c.frozen, llr, cw, hat, rows)
    assert got.tolist()[:3] == [3, 3, 0]
    want = torch.zeros_like(words)
    for r, f in marks:
        want[r // rows, f // 32] |= 1 << (f % 32)
    assert torch.equal(words, want)


def test_marks_are_exact_on_every_byte():
    """zero80 marks exactly the zero bytes, in every byte position and on
    every byte value; top_bits moves every pattern of marks."""
    vals = torch.arange(256, dtype=torch.int64)
    for k in range(4):
        x = (vals << (8 * k)) | (0x5A5A5A5A & ~(0xFF << (8 * k)))
        z = count_kernel._zero80(x)
        assert torch.equal(z >> (8 * k + 7) & 1, (vals == 0).long())
        assert int((z & ~(0x80 << (8 * k))).max()) == 0      # 0x5A bytes
    pats = torch.arange(16, dtype=torch.int64)
    x = sum(((pats >> j) & 1) << (8 * j + 7) for j in range(4))
    assert torch.equal(count_kernel._top_bits(x), pats)
    assert torch.equal(count_kernel._marks(x),
                       sum((pats >> j) & 1 for j in range(4)))


@pytest.mark.parametrize("n,batch,sms", [(2, 1, 132), (2048, 4099, 132),
                                         (16384, 4096, 132),
                                         (131072, 4096, 132),
                                         (131072, 16384, 132),
                                         (1 << 20, 1 << 20, 132),
                                         (131072, 4096, 1)])
def test_count_plan_covers_the_rows(n, batch, sms):
    groups, chunks, rows = count_kernel.count_plan(n, batch, sms)
    assert groups == -(-batch // count_kernel.GROUP_FRAMES)
    assert 1 <= chunks <= 65535 and (chunks - 1) * rows < n <= chunks * rows
    assert rows >= min(n, count_kernel.MIN_CHUNK_ROWS)
    if n >= count_kernel.MIN_CHUNK_ROWS * 8:
        # the card is filled: at least half the CTAs aimed for, or every
        # chunk at its least rows
        assert (groups * chunks >= count_kernel.CTAS_PER_SM * sms // 2
                or rows < 2 * count_kernel.MIN_CHUNK_ROWS)


def test_count_styles_on_the_cpu():
    """A CPU tensor runs the plain version; the wrapper has one kernel and
    takes no style; no kernel launch is counted."""
    c = pt.make_code(7, rate=0.5)
    t = [torch.from_numpy(x) for x in _inputs(c.N, 40, 3)]
    before = dict(count_kernel.plain_calls)
    launched = dict(count_kernel.launches)
    got = count_kernel.count(c.frozen, *t)
    assert torch.equal(got, count_kernel.count_plain(c.frozen, *t))
    assert count_kernel.plain_calls["count_plain"] == before["count_plain"] + 2
    with pytest.raises(TypeError, match="style"):
        count_kernel.count(c.frozen, *t, style=None)
    assert count_kernel.launches == launched
    assert [c for c in vars(count_kernel) if c.endswith("launches")] == [
        "launches"]


class _Asked(Exception):
    pass


def test_both_styles_ask_for_their_tensors_device(monkeypatch):
    """On fake ``cuda:1`` tensors the counter asks ``build.stream`` for
    that device before it loads the library."""
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
        t = [torch.empty((c.N, 8), dtype=torch.int8, device=dev)
             for _ in range(3)]
        with pytest.raises(_Asked):
            count_kernel.count(c.frozen, *t)
    assert [(d.type, d.index) for d in asked] == [("cuda", 1)]
