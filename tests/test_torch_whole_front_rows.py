"""The whole front on row words and decode+count on the tile core, on the
CPU, where their kernels (``csrc/front.cu`` ``front_rows_kernel``,
``csrc/step.cu`` ``decode_count_tile_kernel``) cannot run: the torch twins
of their data flow in ``ops/cuda/step_kernel.py`` against the plain
versions bit for bit and against the JAX package's ``make_pallas_front`` /
``make_pallas_decode_count`` in interpret mode, and the wrappers' level
rules and choice of kernel.

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
                                              make_pallas_decode_count,
                                              make_pallas_front)
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import (build, decoder_kernel, front_kernel,
                                      step_kernel)

# the batches of tests/test_torch_front_rowwords.py, and one that is a
# multiple of four (the word stores) but not of 32
BATCHES = [1, 31, 33, 999, 1000]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The twins run many small torch ops: one intra-op thread, as in
    tests/test_torch_front_rowwords.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


def _inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    msg = (1 - 2 * rng.integers(0, 2, (n, batch))).astype(np.int8)
    return msg, rng.standard_normal((n, batch), np.float32)


def _tie_llrs(n, batch, seed):
    """Mostly -1, 0, +1, some +-2 and the extremes: many ties in every
    SPC, REP and f node."""
    rng = np.random.default_rng(seed)
    values = np.array([-1, 0, 1, 0, -1, 1, 2, -2, -128, 127], np.int8)
    return values[rng.integers(0, len(values), (n, batch))]


# -- (a) the row-word front

@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("m", range(1, 13))
def test_front_rows_twin_matches_plain(m, batch):
    """The twin of front_rows_kernel's order == front_plain, native and
    inject; a native frame draws one Philox block per four message rows
    with an info row and none for four frozen rows."""
    c = pt.make_code(m, rate=0.5)
    msg, nrm = _inputs(c.N, batch, 100 * m + batch)
    params = snr_params(-1.0)
    for kw in (dict(msg_t=torch.from_numpy(msg),
                    normals_t=torch.from_numpy(nrm)),
               dict(seeds=(5, 6), call=2, batch=batch, device="cpu")):
        llr, cw, drawn = step_kernel.front_rows_twin(c.frozen, params, **kw)
        want = step_kernel.front_plain(c.frozen, params, **kw)
        assert torch.equal(llr, want[0]) and torch.equal(cw, want[1])
        if "seeds" in kw:
            chunks = np.asarray(c.frozen, bool).reshape(-1, min(4, c.N))
            assert drawn == int((~chunks.all(axis=1)).sum())


def test_front_rows_twin_word_stores_move_every_byte():
    """The word stores' staging, on LLRs that differ at every frame and
    row: what the stores leave is the array itself."""
    rng = np.random.default_rng(3)
    for n, c in ((2, 1), (4, 2), (16, 4)):    # c = min(4, N/2) pair rows
        llr = torch.from_numpy(rng.integers(-128, 128, (n, 1000))
                               .astype(np.int8))
        assert torch.equal(step_kernel._staged_llr_words(llr, c), llr)


@pytest.mark.parametrize("m,snr", [(6, -1.0), (8, 0.5)])
def test_front_rows_inject_twin_matches_pallas_front(m, snr):
    """The inject twin against JAX's whole front in interpret mode."""
    jc = jpt.make_code(m, rate=0.5)
    msg, nrm = _inputs(jc.N, 256, 7 * m)
    jfront = make_pallas_front(jc, frame_tile=128, interpret=True,
                               prng="inject")
    want = jax.jit(jfront, static_argnums=2)(jnp.asarray(msg),
                                             jnp.asarray(nrm), snr)
    llr, cw, _ = step_kernel.front_rows_twin(
        pt.code_from_jax(jc).frozen, _jax_params(snr),
        msg_t=torch.from_numpy(msg), normals_t=torch.from_numpy(nrm))
    assert int((llr == 0).sum()) > 0
    np.testing.assert_array_equal(llr.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(want[1]))


# -- (b) decode+count's packed counting

@pytest.mark.parametrize("batch", [1, 7, 8, 31, 33, 999])
@pytest.mark.parametrize("m", [2, 6, 8, 10])
def test_count_tile_twin_matches_plain(m, batch):
    """The tile kernel's counting (tiles of two packed words, live-frame
    masks, info-row masks, the lane OR, the channel pass, per-block sums)
    == decode_count_plain on tie-heavy LLRs, at ragged batches; a frame of
    the batch errs at most once."""
    c = pt.make_code(m, rate=0.5)
    program = pt.compile_program(c)
    llr = torch.from_numpy(_tie_llrs(c.N, batch, m * 1000 + batch))
    msg, _ = _inputs(c.K, batch, batch)
    cw = pt.encode_systematic(c, torch.from_numpy(msg).t()).t().contiguous()
    got, blocks = step_kernel.count_tile_twin(program, c.frozen, llr, cw)
    want = step_kernel.decode_count_plain(program, c.frozen, llr, cw)
    assert torch.equal(got, want)
    tiles = -(-batch // decoder_kernel.WHOLE_FRAMES)
    warps = step_kernel.decode_count_warps(c.N, batch)
    assert blocks.shape == (-(-tiles // warps), 5)
    assert 0 <= int(got[1]) <= batch
    assert int(got[4]) == int((llr == 0).sum())
    # the sums do not depend on how tiles are grouped into blocks
    assert torch.equal(step_kernel.count_tile_twin(program, c.frozen, llr, cw,
                                                   warps=1)[0], want)


@pytest.mark.parametrize("m", [6, 8])
def test_count_tile_twin_matches_pallas_decode_count(m):
    """The twin against JAX's decode+count in interpret mode, on
    tie-heavy LLRs and on a front's outputs."""
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    program = pt.compile_program(code)
    msg, nrm = _inputs(jc.N, 256, 11 * m)
    llr_f, cw = step_kernel.front_plain(code.frozen, _jax_params(-1.0),
                                        msg_t=torch.from_numpy(msg),
                                        normals_t=torch.from_numpy(nrm))
    count = jax.jit(make_pallas_decode_count(jc, frame_tile=128,
                                             interpret=True))
    for llr in (torch.from_numpy(_tie_llrs(jc.N, 256, m)), llr_f):
        got, _ = step_kernel.count_tile_twin(program, code.frozen, llr, cw)
        want = count(jnp.asarray(llr.numpy()), jnp.asarray(cw.numpy()))
        assert got.tolist() == [int(want[k]) for k in step_kernel.COUNTERS]


# -- (c) the level rules and the choice of kernel

def test_level_limits_follow_the_shared_memory_arithmetic():
    smem = decoder_kernel.SCRATCH_SMEM_BYTES
    top = step_kernel.FRONT_ROWS_MAX_LEVEL
    stage = 4 * step_kernel.FRONT_ROWS_STAGE * step_kernel.FRONT_ROWS_MAX_WARPS
    assert top == 15 and 1 << top == front_kernel.ROWS_MAX_WORDS
    assert 4 * (1 << top) + stage <= smem < 4 * (1 << (top + 1)) + stage
    whole = decoder_kernel.WHOLE_MAX_LEVEL
    assert whole == 13
    assert (decoder_kernel.tile_bytes(1 << whole, True) <= smem
            < decoder_kernel.tile_bytes(1 << (whole + 1), True))
    for m in range(1, 18):
        n = 1 << m
        assert step_kernel.front_kernel_name(n) == (
            "rows" if m <= top else "thread")
        assert step_kernel.front_kernel_name(n, "thread") == "thread"
        assert decoder_kernel.ssa_kernel(n) == (
            "tile" if m <= whole else "walk")
    with pytest.raises(ValueError, match="style"):
        step_kernel.front_kernel_name(256, "frame")


def test_front_rows_warps_rule():
    """FRONT_ROWS_MAX_WARPS warps a CTA, or one a chunk of four pair rows
    where the code has fewer chunks."""
    assert [step_kernel.front_rows_warps(1 << m) for m in range(1, 8)] == [
        1, 1, 1, 2, 4, 8, 8]
    assert step_kernel.front_rows_warps(1 << 15) == (
        step_kernel.FRONT_ROWS_MAX_WARPS)


def test_decode_count_warps_rule():
    """The whole-code tile decoder's tiles a block on the cw track, but
    from COUNT_BIG_BATCH frames the A/B's counts at the levels it lists;
    every count fits a block's shared memory."""
    for m in range(1, decoder_kernel.WHOLE_MAX_LEVEL + 1):
        n = 1 << m
        for batch in (1, 4096, step_kernel.COUNT_BIG_BATCH - 1,
                      step_kernel.COUNT_BIG_BATCH, 32768):
            w = step_kernel.decode_count_warps(n, batch)
            big = batch >= step_kernel.COUNT_BIG_BATCH
            assert w == (step_kernel.COUNT_BIG_WARPS[m]
                         if big and m in step_kernel.COUNT_BIG_WARPS
                         else decoder_kernel.tile_warps(n, True))
            assert w * decoder_kernel.tile_bytes(n, True) <= (
                decoder_kernel.SCRATCH_SMEM_BYTES)
    assert [step_kernel.decode_count_warps(1 << m, 32768)
            for m in (8, 9, 10, 11)] == [8, 8, 2, 1]


@pytest.mark.parametrize("style", step_kernel.FRONT_STYLES)
def test_cpu_tensors_run_the_plain_front_in_every_style(style):
    c = pt.make_code(5, rate=0.5)
    msg, nrm = _inputs(c.N, 9, 1)
    launched = (dict(step_kernel.launches), dict(step_kernel.earlier_launches))
    plain = step_kernel.plain_calls["front_plain"]
    for kw in (dict(msg_t=torch.from_numpy(msg),
                    normals_t=torch.from_numpy(nrm)),
               dict(seeds=(1, 2), call=0, batch=9, device="cpu")):
        got = step_kernel.front(c.frozen, (0.8, 3.125), style=style, **kw)
        want = step_kernel.front_plain(c.frozen, (0.8, 3.125), **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert step_kernel.plain_calls["front_plain"] == plain + 4
    assert (step_kernel.launches, step_kernel.earlier_launches) == launched


@pytest.mark.parametrize("style", step_kernel.DECODE_COUNT_STYLES)
def test_cpu_tensors_run_the_plain_decode_count_in_every_style(style):
    c = pt.make_code(5, rate=0.5)
    program = pt.compile_program(c)
    llr = torch.from_numpy(_tie_llrs(c.N, 9, 2))
    cw = torch.from_numpy(np.ones((c.N, 9), np.int8))
    launched = (dict(step_kernel.launches), dict(step_kernel.earlier_launches))
    plain = step_kernel.plain_calls["decode_count_plain"]
    got = step_kernel.decode_count(program, c.frozen, llr, cw, style=style)
    assert step_kernel.plain_calls["decode_count_plain"] == plain + 1
    assert torch.equal(got, step_kernel.decode_count_plain(program, c.frozen,
                                                           llr, cw))
    assert (step_kernel.launches, step_kernel.earlier_launches) == launched
    with pytest.raises(ValueError, match="style"):
        step_kernel.decode_count(program, c.frozen, llr, cw, style="tile")


class _Lib:
    """Stands in for the kernels' library: records each C entry called and
    its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _fake(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(decoder_kernel, "_tables", {})    # fake device copies
    monkeypatch.setattr(step_kernel, "launches", dict(step_kernel.launches))
    monkeypatch.setattr(step_kernel, "earlier_launches",
                        dict(step_kernel.earlier_launches))
    return lib


@pytest.mark.parametrize("m", [2, 13, 14, 15, 16])
def test_cuda_tensors_take_each_kernel_by_its_level(monkeypatch, m):
    """On (fake) CUDA tensors the front takes the row-word kernel up to
    FRONT_ROWS_MAX_LEVEL and the thread kernel above it or by name, with
    the rule's warps and word stores where B % 4 == 0; decode+count takes
    the tile kernel up to WHOLE_MAX_LEVEL and the walk above it or by
    name. Each launch counts where its kernel's does."""
    lib = _fake(monkeypatch)
    c = pt.make_code(m, rate=0.5)
    n, b = c.N, 8
    dev = torch.device("cuda", 0)
    with FakeTensorMode(allow_non_fake_inputs=True):
        msg = torch.empty((n, b), dtype=torch.int8, device=dev)
        nrm = torch.empty((n, b), dtype=torch.float32, device=dev)
        step_kernel.front(c.frozen, (0.5, 8.0), msg_t=msg, normals_t=nrm)
        step_kernel.front(c.frozen, (0.5, 8.0), seeds=(1, 2), batch=b,
                          device=dev, style="thread")
        if m <= 14:
            program = pt.compile_program(c)
            step_kernel.decode_count(program, c.frozen, msg, msg)
            step_kernel.decode_count(program, c.frozen, msg, msg,
                                     style="walk")
    rows = m <= step_kernel.FRONT_ROWS_MAX_LEVEL
    tile = m <= decoder_kernel.WHOLE_MAX_LEVEL
    names = [name for name, _ in lib.calls]
    want = ["polar_front_rows" if rows else "polar_front_whole",
            "polar_front_whole"]
    if m <= 14:
        want += ["polar_decode_count_tile" if tile else "polar_decode_count",
                 "polar_decode_count"]
    assert names == want
    if rows:
        args = lib.calls[0][1]
        assert args[-3:-1] == (step_kernel.front_rows_warps(n), 1)
    if tile:
        args = lib.calls[2][1]
        assert args[-3] == step_kernel.decode_count_warps(n, b)
    assert step_kernel.launches["front_whole"] == rows
    assert step_kernel.earlier_launches["front_whole_thread"] == 2 - rows
    if m <= 14:
        assert step_kernel.launches["decode_count"] == tile
        assert step_kernel.earlier_launches["decode_count_walk"] == 2 - tile
