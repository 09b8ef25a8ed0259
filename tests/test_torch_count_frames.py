"""The u-domain counter of the draws path's step on the CPU, where its
kernel (``csrc/count.cu`` ``count_frames_kernel``) cannot run: the torch
twin of the kernel's decomposition in ``ops/cuda/count_kernel.py`` (spans
of lanes over 16-byte row words padded with 0x01 bytes, the byte marks, a
ballot a frame unit, CTA partials and their fold) and the wrapper's plain
version, against ``ber.frame_counters`` and the JAX package's draws-step
counters, bit for bit; the launch plan; the wrapper on the CPU and its
checks on (fake) card tensors (``tests/test_torch_device.py`` holds that it
asks for its tensors' device first).

Inputs are made with numpy from a seed: full-range int8 with forced zeros
in ``decoded`` and ``llrs``, the values -128 and 0, frames all correct and
all wrong, and batches and row lengths off the 16-byte word. The card
tests of the kernel itself are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ber import make_step_body as j_step_body
from polar_tpu.channel import awgn_llrs as j_awgn_llrs
from polar_tpu.encode import encode as j_encode
from polar_tpu_torch import ber
from polar_tpu_torch.ops.cuda import build, count_kernel
from polar_tpu_torch.ops.cuda.step_kernel import COUNTERS


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _inputs(batch, k, n, seed):
    """(message, codeword, llrs, decoded) int8 torch: ±1 message and
    codeword, full-range LLRs with about 10 % zeros, full-range estimates
    with about 10 % zeros; frame 0 all correct, frame 1 all wrong (when
    the batch has them), -128 and 0 in both full-range tensors."""
    rng = np.random.default_rng(seed)
    msg = (1 - 2 * rng.integers(0, 2, (batch, k))).astype(np.int8)
    cw = (1 - 2 * rng.integers(0, 2, (batch, n))).astype(np.int8)
    llr, dec = _i8(rng, (batch, n)), _i8(rng, (batch, k))
    llr[rng.random(llr.shape) < 0.1] = 0
    dec[rng.random(dec.shape) < 0.1] = 0
    llr.flat[::7], dec.flat[::5] = -128, -128
    dec[0] = msg[0]
    if batch > 1:
        dec[1] = -msg[1]
    return tuple(torch.from_numpy(x) for x in (msg, cw, llr, dec))


def _frame_counters(message, codeword, llrs, decoded):
    got = ber.frame_counters(message, codeword, llrs, decoded)
    return torch.stack([got[c] for c in COUNTERS])


# batch, K, N: a lane a frame up to a warp a frame, rows on and off the
# 16-byte word, ragged frame units
_SHAPES = [(1, 8, 16), (3, 1, 2), (33, 8, 16), (37, 13, 29), (40, 16, 32),
           (129, 48, 96), (17, 512, 1024), (5, 300, 1100), (2, 2048, 4096)]


@pytest.mark.parametrize("batch,k,n", _SHAPES)
def test_twin_and_plain_match_frame_counters(batch, k, n):
    """count_frames_plain == frame_counters == the twin at the plan's
    launch and at every span of lanes and a few grids."""
    t = _inputs(batch, k, n, batch * 7 + k)
    want = _frame_counters(*t)
    assert torch.equal(count_kernel.count_frames_plain(*t), want)
    if batch > 1:
        assert int(want[1]) < batch          # frame 0 is correct
    span_log2, blocks = count_kernel.count_frames_plan(batch, k, n, 792)
    got, partials = count_kernel.count_frames_twin(*t, span_log2, blocks)
    assert torch.equal(got, want) and partials.shape == (blocks, 5)
    for s in range(6):
        for grid in (1, 7):
            got, partials = count_kernel.count_frames_twin(*t, s, grid)
            assert torch.equal(got, want), (s, grid)
            assert torch.equal(partials.sum(0), want)


def test_twin_counts_each_frame_once_in_its_cta():
    """One wrong bit in a chosen frame: the frame error lands in the CTA
    whose warp takes the frame's unit, at every span."""
    batch, k, n = 300, 40, 80
    msg, cw, llr, _ = _inputs(batch, k, n, 3)
    dec = msg.clone()
    dec[250, 39] = -dec[250, 39]
    dec[7, 0] = 0
    for s in range(6):
        _, partials = count_kernel.count_frames_twin(msg, cw, llr, dec, s, 3)
        want = torch.zeros((3, 3), dtype=torch.int64)
        for f, amb in ((250, 0), (7, 1)):
            cta = (f >> (5 - s)) % (3 * count_kernel.FRAME_WARPS) \
                // count_kernel.FRAME_WARPS
            want[cta, :3] += torch.tensor([1, 1, amb])
        assert torch.equal(partials[:, :3], want), s


def test_plain_and_twin_match_the_jax_draws_step():
    """The JAX package's draws step (threefry) around a pinned decoder
    that returns a chosen full-range estimate: its counters equal the
    plain version's and the twin's on the same message, codeword and
    LLRs. K = 19 and N = 64 at 37 frames: rows and batch off the word."""
    m, batch = 6, 37
    jc = jpt.make_code(m, rate=0.3)
    assert jc.K % 16
    rng = np.random.default_rng(m)
    dec = _i8(rng, (batch, jc.K))
    dec[rng.random(dec.shape) < 0.2] = 0
    dec[0] = -128       # frame 0: wrong exactly where the message is +1
    step = j_step_body(jc, systematic=False,
                       decoder=lambda llrs: jnp.asarray(dec))

    def draws_and_step(key):
        """The step's own draws (``polar_tpu/ber.py`` ``draw_threefry``)
        and its counters, in one jit."""
        kmsg, knoise = jax.random.split(key)
        msg = jnp.where(jax.random.bernoulli(kmsg, 0.5, (batch, jc.K)),
                        jnp.int8(-1), jnp.int8(1))
        cw = j_encode(jc, msg)
        return (msg, cw, j_awgn_llrs(knoise, cw, -1.0, jnp.int8),
                step(key, -1.0, batch))

    *draws, want = jax.jit(draws_and_step)(jax.random.PRNGKey(m))
    t = [torch.from_numpy(np.array(x)) for x in draws]
    t.append(torch.from_numpy(dec))
    got = count_kernel.count_frames_plain(*t)
    assert got.tolist() == [int(want[c]) for c in COUNTERS]
    assert int(got[3]) > 0 and int(got[4]) > 0
    span_log2, blocks = count_kernel.count_frames_plan(batch, jc.K, jc.N,
                                                        792)
    assert torch.equal(count_kernel.count_frames_twin(*t, span_log2,
                                                      blocks)[0], got)


@pytest.mark.parametrize("batch,k,n,resident", [
    (1, 8, 16, 792), (4096, 8192, 16384, 792), (32768, 512, 1024, 792),
    (32768, 512, 1024, 396), (4097, 13, 29, 396), (10**6, 16, 32, 792),
    (64, 8192, 16384, 1)])
def test_count_frames_plan(batch, k, n, resident):
    """The span covers a frame's longest row in 16-byte words (at most a
    warp); the grid covers every frame unit, at most one resident wave."""
    span_log2, blocks = count_kernel.count_frames_plan(batch, k, n, resident)
    span, words = 1 << span_log2, -(-max(k, n) // 16)
    assert 0 <= span_log2 <= 5
    assert span >= min(words, 32) and (span == 1 or span // 2 < words)
    units = -(-batch // (32 // span))
    assert 1 <= blocks <= resident
    assert blocks == min(-(-units // count_kernel.FRAME_WARPS), resident)


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("per_sm,straight", [(6, True), (3, False)])
def test_frame_wave_is_the_reported_occupancy(monkeypatch, per_sm,
                                              straight):
    """The grid's cap is the occupancy the runtime reports for the
    instance launched, times the SMs, asked once a device and instance."""
    asked = []

    class _Lib:
        def polar_count_frames_occupancy(self, flag, out):
            asked.append(flag)
            out._obj.value = per_sm
            return 0

    monkeypatch.setattr(build, "load_library", _Lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(count_kernel, "_frame_waves", {})
    dev = torch.device("cuda", 0)
    for _ in range(2):
        assert count_kernel.frame_wave(dev, straight) == per_sm * 132
    assert asked == [int(straight)]


def test_frame_wave_refuses_a_cta_that_does_not_fit(monkeypatch):
    class _Lib:
        def polar_count_frames_occupancy(self, flag, out):
            out._obj.value = 0
            return 0

    monkeypatch.setattr(build, "load_library", _Lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    monkeypatch.setattr(count_kernel, "_frame_waves", {})
    with pytest.raises(RuntimeError, match="does not fit"):
        count_kernel.frame_wave(torch.device("cuda", 0), True)


def test_count_frames_on_the_cpu():
    """CPU tensors take the plain version: counted in plain_calls, no
    launch; an empty batch counts nothing."""
    t = _inputs(9, 24, 40, 1)
    before = dict(count_kernel.plain_calls)
    launched = dict(count_kernel.launches)
    got = count_kernel.count_frames(*t)
    assert got.dtype == torch.int64 and got.shape == (5,)
    assert torch.equal(got, _frame_counters(*t))
    assert count_kernel.plain_calls["count_frames_plain"] == \
        before["count_frames_plain"] + 1
    assert count_kernel.launches == launched
    empty = [x[:0] for x in t]
    assert count_kernel.count_frames(*empty).tolist() == [0] * 5


def test_draws_step_counts_through_count_frames():
    """The kernel-draws step (plain versions here) counts through
    count_frames, and the torch-draws step through frame_counters: each
    step of the first adds one plain count_frames call, the second none."""
    code = pt.make_code(6, rate=0.5)
    dec = pt.make_fastssc_decoder(code, output="u", output_dtype=torch.int8)
    for rng, calls in (("kernel", 1), ("torch", 0)):
        step = ber.make_step_body(code, systematic=False, rng=rng,
                                  decoder=dec, device="cpu")
        gen = torch.Generator()
        gen.manual_seed(4)
        before = count_kernel.plain_calls["count_frames_plain"]
        out = step(gen, -1.0, 50)
        assert count_kernel.plain_calls["count_frames_plain"] == \
            before + calls
        assert list(out) == list(COUNTERS)
        assert all(v.dtype == torch.int64 and v.ndim == 0
                   for v in out.values())
        assert int(out["awgn_errors"]) > 0


def _fake(shapes, dtype=torch.int8, dev=torch.device("cuda", 1)):
    return [torch.empty(s, dtype=dtype, device=dev) for s in shapes]


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device"])
def test_count_frames_refuses_what_the_kernel_does_not_take(monkeypatch,
                                                            bad):
    """A card tensor of another dtype, shape, layout or device raises
    before any launch: the wrapper never falls back."""
    monkeypatch.setattr(build, "stream", lambda device: pytest.fail(
        "a launch was prepared"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        msg, cw, llr, dec = _fake([(8, 16), (8, 32), (8, 32), (8, 16)])
        if bad == "dtype":
            dec = _fake([(8, 16)], torch.int16)[0]
        elif bad == "shape":
            llr = _fake([(8, 31)])[0]
        elif bad == "layout":
            cw = _fake([(32, 8)])[0].t()
        else:
            dec = _fake([(8, 16)], dev=torch.device("cuda", 0))[0]
        with pytest.raises(ValueError, match="expected contiguous"):
            count_kernel.count_frames(msg, cw, llr, dec)


@pytest.mark.parametrize("m,batch,want", [
    (9, 32768, "fused"), (10, 4096, "fused"), (10, 32768, "draws"),
    (11, 4096, "fused"), (11, 32768, "draws"), (12, 4096, "draws"),
    (12, 32768, "draws"), (13, 4096, "draws")])
def test_auto_step_path_of_plain_codes(m, batch, want):
    """make_step's own plain int8 step on a card, by level and batch:
    the draws (with this counter) from m = 10 at AUTO_BIG_BATCH and from
    m = 12 at every batch, the fused step below; a CPU device takes the
    torch draws."""
    code = pt.make_code(m, rate=0.5)
    assert ber._step_path(code, torch.int8, None, None, "auto", "cuda",
                          False, batch) == want
    assert ber._step_path(code, torch.int8, None, None, "auto", "cpu",
                          False, batch) == ("fused" if want == "fused"
                                            else "plain")
