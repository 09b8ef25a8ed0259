"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: it is marked ``cuda`` and skips
without one. The file imports neither JAX nor polar_tpu, so it runs where
only torch is installed; ``tests/conftest.py`` imports JAX, so on such a
machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import polar_tpu_torch as pt
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.decode.auto import make_kernel_decoder
from polar_tpu_torch.ops.cuda import decoder_kernel, step_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _llrs(dev, n, b, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-128, 128, (n, b), generator=g, device=dev,
                      dtype=torch.int8)
    x[:, 0] = -128
    x[:, 1] = 0
    return x


@pytest.mark.parametrize("m", [2, 5, 9, 10, decoder_kernel.WHOLE_MAX_LEVEL])
@pytest.mark.parametrize("batch", [1, 3, 63, 4099, 32768])
def test_decoder_kernel_matches_plain(dev, m, batch):
    """The tile kernel, both tracks, up to its limit; column 0 all -128,
    column 1 all zero."""
    c = pt.make_code(m, rate=0.5)
    assert decoder_kernel.ssa_kernel(c.N) == "tile"
    llr = _llrs(dev, c.N, max(batch, 2), m)[:, :batch].contiguous()
    program = pt.compile_program(c)
    for want_cw in (False, True):
        before = dict(decoder_kernel.launches)
        got = decoder_kernel.decode(program, c.frozen, llr, want_cw)
        want = decoder_kernel.decode_plain(program, c.frozen, llr, want_cw)
        track = "fastssc_decoder_cw" if want_cw else "fastssc_decoder_u"
        assert decoder_kernel.launches == {**before, track: before[track] + 1}
        assert torch.equal(got[0], want[0])
        if want_cw:
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("batch", [63, 4099])
def test_walk_above_the_limit_and_by_name(dev, batch):
    """Above WHOLE_MAX_LEVEL style "ssa" runs the walk; "walk" runs it at
    any level; both equal the plain version and the tile kernel."""
    for m, style in ((decoder_kernel.WHOLE_MAX_LEVEL + 1, "ssa"),
                     (10, "walk")):
        c = pt.make_code(m, rate=0.5)
        llr = _llrs(dev, c.N, batch, m)
        program = pt.compile_program(c)
        for want_cw in (False, True):
            before = dict(decoder_kernel.launches)
            got = decoder_kernel.decode(program, c.frozen, llr, want_cw, style)
            track = "walk_decoder_cw" if want_cw else "walk_decoder_u"
            assert decoder_kernel.launches == {**before,
                                               track: before[track] + 1}
            want = decoder_kernel.decode_plain(program, c.frozen, llr, want_cw)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)
            if m <= decoder_kernel.WHOLE_MAX_LEVEL:
                tile = decoder_kernel.decode(program, c.frozen, llr, want_cw)
                for g, t in zip(got, tile):
                    assert (g is None and t is None) or torch.equal(g, t)


def test_tile_kernel_rows_off_the_word(dev):
    """B % 16 != 0, or arrays that start off a 16-byte boundary, take the
    byte-wise row accesses."""
    c = pt.make_code(8, rate=0.5)
    program = pt.compile_program(c)
    for batch, shift in ((4096, 1), (4096, 4), (4097, 0), (4100, 0)):
        buf = torch.empty(c.N * batch + shift, dtype=torch.int8, device=dev)
        llr = buf[shift:].view(c.N, batch)
        llr.copy_(_llrs(dev, c.N, batch, batch))
        assert (llr.data_ptr() % 16 == 0) == (shift == 0)
        for want_cw in (False, True):
            got = decoder_kernel.decode(program, c.frozen, llr, want_cw)
            want = decoder_kernel.decode_plain(program, c.frozen, llr, want_cw)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)


def test_simd_primitives_match_the_scalar_functions(dev):
    bad = decoder_kernel.simd_selftest(dev)
    assert set(bad) == set(decoder_kernel.SIMD_PRIMITIVES)
    assert all(v == 0 for v in bad.values()), bad


def test_kernel_decoder_output_modes(dev):
    c = pt.make_code(9, rate=0.25)
    llr = _llrs(dev, c.N, 777, 3).t().contiguous()       # (B, N)
    for style in ("ssa", "walk"):
        route = "fastssc_decoder" if style == "ssa" else "walk_decoder"
        for mode in ("u", "systematic", "codeword", "both"):
            before = dict(decoder_kernel.launches)
            got = make_kernel_decoder(c, output=mode, style=style)(llr)
            track = f"{route}_{'u' if mode == 'u' else 'cw'}"
            if mode == "u" and style == "ssa":   # the (B, N) launch
                track = "fastssc_decoder_u_frames"
            assert decoder_kernel.launches == {**before,
                                               track: before[track] + 1}
            want = pt.make_fastssc_decoder(c, output=mode,
                                           output_dtype=torch.int8)(llr)
            for a, b in zip(*((got, want) if mode == "both"
                              else ((got,), (want,)))):
                assert torch.equal(a, b)
    from polar_tpu_torch.decode import auto

    _, desc = pt.make_auto_decoder(c, output="codeword", device=dev)
    assert desc == "cuda-fastssc; float32 LLRs: eager"       # the tile kernel
    # u: the same below BIG_BATCH, the scratch style from it
    _, desc = pt.make_auto_decoder(c, device=dev)
    assert desc == f"cuda-fastssc below {auto.BIG_BATCH} frames, " \
                   "cuda-scratch from it; float32 LLRs: cuda-f32"


def test_decoder_rejects_bad_input(dev):
    c = pt.make_code(6, rate=0.5)
    program = pt.compile_program(c)
    with pytest.raises(ValueError):
        decoder_kernel.decode(program, c.frozen,
                              torch.zeros(c.N, 8, dtype=torch.int16, device=dev), False)
    with pytest.raises(ValueError):
        decoder_kernel.decode(program, c.frozen,
                              torch.zeros(8, c.N, dtype=torch.int8, device=dev).t(), False)


@pytest.mark.parametrize("m", [3, 8, 10])
@pytest.mark.parametrize("systematic", [True, False])
def test_step_kernel_inject_matches_plain(dev, m, systematic):
    c = pt.make_code(m, rate=0.5)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    batch = 1000
    msg = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                 device=dev)).to(torch.int8)
    nrm = torch.randn((c.N, batch), generator=g, device=dev)
    args = (pt.compile_program(c), c.frozen, snr_params(0.0), systematic)
    got = step_kernel.step(*args, msg_t=msg, normals_t=nrm)
    assert torch.equal(got, step_kernel.step_plain(*args, msg_t=msg, normals_t=nrm))
    assert int(got[3]) > 0


def test_step_kernel_native_matches_plain_bits(dev):
    c = pt.make_code(8, rate=0.5)
    args = (pt.compile_program(c), c.frozen, snr_params(1.0), True)
    kw = dict(seeds=(77, 78), call=5, batch=3000, device=dev)
    a = step_kernel.step(*args, **kw)
    assert torch.equal(a, step_kernel.step(*args, **kw))
    b = step_kernel.step_plain(*args, **kw)
    # identical Philox words; an ulp of log/sqrt may move an LLR (see
    # chip_smoke.py phase 4): at most 3 frames' worth of bits apart
    assert int((a - b).abs().max()) <= 3 * c.K


def test_campaign_runs_through_the_kernels(dev):
    c = pt.make_code(7, rate=0.5)
    for counts in (decoder_kernel.launches, step_kernel.launches):
        for k in counts:
            counts[k] = 0
    res = pt.run_campaign(c, device=dev, batch=4096, max_frames_per_point=8192,
                          snr_range=(0.0, 2.0), snr_step=1.0)
    assert len(res.points) == 3 and res.points[0].bit_errors > 0
    assert step_kernel.launches["mc_step"] > 0
    assert decoder_kernel.launches["fastssc_decoder_cw"] > 0
    assert np.isfinite(res.peak_mbps) and res.peak_mbps > 0


def _subtree_nodes(m, level):
    """Composite nodes of one level of Polar(2^m, 2^(m-1)) that take a
    subtree kernel, one per kind present."""
    out, stack = {}, [pt.compile_code(pt.make_code(m, rate=0.5))]
    while stack:
        node = stack.pop()
        if node.level == level and node.mesg_bits >= 1 and node.kind in (
                "branch", "rate0_right", "rate1_comb"):
            out.setdefault(node.kind, node)
        stack.extend(c for c in (node.left, node.right) if c is not None)
    return list(out.values())


@pytest.mark.parametrize("level", [4, 7])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_subtree_kernel_matches_plain(dev, level, batch):
    from polar_tpu_torch.ops.cuda import subtree_kernel

    nodes = _subtree_nodes(11, level)
    assert nodes
    for node in nodes:
        n = 1 << node.level
        slot = _llrs(dev, 2 * n, max(batch, 2), level)[:, :batch].contiguous()
        g = torch.Generator(device=dev)
        g.manual_seed(batch)
        hl = torch.randint(-1, 2, (n, batch), generator=g, device=dev,
                           dtype=torch.int8)
        cwl = torch.randint(-1, 2, (n, batch), generator=g, device=dev,
                            dtype=torch.int8)
        for fuse in (None, "f", "g"):
            for emit_u, emit_cw in ((True, False), (True, True), (False, True)):
                fn = subtree_kernel.make_subtree_decoder(
                    node, emit_u=emit_u, emit_cw=emit_cw, fuse=fuse)
                args = ((slot[:n].contiguous(),) if fuse is None else
                        (slot,) if fuse == "f" else
                        (slot, hl) + ((cwl,) if emit_cw else ()))
                before = subtree_kernel.launches["subtree_decoder"]
                got = fn(*args)
                assert subtree_kernel.launches["subtree_decoder"] == before + 1
                want = subtree_kernel.decode_plain(
                    node, [a.cpu() for a in args], fuse=fuse, emit_u=emit_u,
                    emit_cw=emit_cw)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert torch.equal(a.cpu(), b), (node.kind, fuse, emit_u)


def test_auto_decoder_picks_the_hybrid_from_its_level(dev):
    from polar_tpu_torch.decode import auto

    kl, big = auto.HYBRID_KERNEL_LEVEL, auto.BIG_BATCH
    interp = f"cuda-interp-sl{auto.INTERP_SUBTREE_LEVEL}"
    for m, output, want in (
            (auto.HYBRID_MIN_LEVEL - 2, "codeword", "cuda-fastssc"),
            (13, "codeword", interp),
            (auto.HYBRID_MIN_LEVEL + 2, "codeword", interp),
            (15, "u", interp),
            (18, "u", f"cuda-hybrid-kl{kl}")):
        _, desc = pt.make_auto_decoder(pt.make_code(m, rate=0.5),
                                       output=output, device=dev)
        f32 = ("cuda-f32" if output == "u"
               and m <= decoder_kernel.F32_MAX_LEVEL else "eager")
        assert desc == f"{want}; float32 LLRs: {f32}"
    # the u track of m = 7 by batch: the tile kernel, then the scratch kernel
    c = pt.make_code(7, rate=0.5)
    dec, desc = pt.make_auto_decoder(c, device=dev)
    assert desc == (f"cuda-fastssc below {big} frames, cuda-scratch from "
                    "it; float32 LLRs: cuda-f32")
    want = pt.make_fastssc_decoder(c, output_dtype=torch.int8)
    for batch in (100, auto.BIG_BATCH):
        llr = _llrs(dev, c.N, batch, batch).t().contiguous()
        before = dict(decoder_kernel.launches)
        assert torch.equal(dec(llr).cpu(), want(llr.cpu()))
        name = ("fastssc_decoder_u_frames" if batch < auto.BIG_BATCH
                else "scratch_decoder_frames")
        assert decoder_kernel.launches == {**before, name: before[name] + 1}


@pytest.mark.parametrize("fuse", [False, True])
def test_hybrid_matches_whole_code_kernel(dev, fuse):
    c = pt.make_code(12, rate=0.5)
    llr = _llrs(dev, c.N, 1000, 12)
    for mode in ("u", "systematic", "codeword", "both"):
        want = make_kernel_decoder(c, output=mode).lane_major(llr)
        for kl in (6, 9):
            got = pt.make_fastssc_decoder(c, output=mode, output_dtype=torch.int8,
                                          kernel_level=kl, kernel_fuse=fuse)
            got_lane = got.lane_major(llr)
            got_frame = got(llr.t().contiguous())
            pairs = (zip(got_lane, want) if mode == "both"
                     else [(got_lane, want)])
            for a, b in pairs:
                assert torch.equal(a, b), (mode, kl)
            pairs = (zip(got_frame, want) if mode == "both"
                     else [(got_frame, want)])
            for a, b in pairs:
                assert torch.equal(a.t(), b), (mode, kl)


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("batch", [1, 999])
def test_front_kernels_match_plain(dev, systematic, batch):
    from polar_tpu_torch.ops.cuda import front_kernel

    c = pt.make_code(10, rate=0.5)
    g = torch.Generator(device=dev)
    g.manual_seed(batch)
    msg = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                 device=dev)).to(torch.int8)
    nrm = torch.randn((c.N, batch), generator=g, device=dev)
    params = snr_params(-1.0)
    for blk in (16, 256):
        a = front_kernel.msg_blocks(c.frozen, blk, systematic, msg_t=msg)
        assert torch.equal(a, front_kernel.msg_blocks_plain(
            c.frozen, blk, systematic, msg_t=msg))
        kw = dict(seeds=(5, 6), call=2, batch=batch, device=dev)
        a = front_kernel.msg_blocks(c.frozen, blk, systematic, **kw)
        assert torch.equal(a, front_kernel.msg_blocks_plain(
            c.frozen, blk, systematic, **kw))
        for inject in (True, False):
            kw = dict(normals_t=nrm) if inject else dict(seeds=(5, 6), call=2)
            got = front_kernel.chan_blocks(a, blk, params, **kw)
            want = front_kernel.chan_blocks_plain(a, blk, params, **kw)
            assert torch.equal(got[1], want[1])
            # native: the same words; an ulp of log/sqrt between the card
            # and torch may move an LLR by one step
            d = (got[0].int() - want[0].int()).abs()
            assert int(d.max()) <= (0 if inject else 1)
            assert int((d != 0).sum()) <= (0 if inject else 3)


def test_count_kernel_matches_plain(dev):
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(11, rate=0.5)
    for batch in (1, 77, 4099):
        llr = _llrs(dev, c.N, max(batch, 2), batch)[:, :batch].contiguous()
        g = torch.Generator(device=dev)
        g.manual_seed(batch)
        cw = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                    device=dev)).to(torch.int8)
        hat = cw.clone()
        flips = torch.randint(0, 400, (c.N, batch), generator=g, device=dev)
        hat[flips == 0] = 0
        hat[flips == 1] *= -1
        got = count_kernel.count(c.frozen, llr, cw, hat)
        want = count_kernel.count_plain(c.frozen, llr, cw, hat)
        assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("systematic", [True, False])
def test_large_n_chain_matches_fused_step(dev, systematic):
    c = pt.make_code(12, rate=0.5)
    chain = pt.ber.make_front_chain(c, systematic=systematic, kernel_level=8)
    kw = dict(seeds=(31, 41), call=0, batch=3000, device=dev)
    for snr in (-1.0, 0.5):
        got = chain(snr_params(snr), **kw)
        want = step_kernel.step(pt.compile_program(c), c.frozen,
                                snr_params(snr), systematic, **kw)
        assert torch.equal(got, want), (snr, got.tolist(), want.tolist())
    assert int(got[3]) > 0


@pytest.mark.parametrize("shape", [(1, 3), (63, 70), (1000, 512)])
def test_symbols_kernel_matches_plain(dev, shape):
    from polar_tpu_torch.ops.cuda import channel_kernel

    before = channel_kernel.launches["channel_symbols"]
    kw = dict(seeds=(12, 34), call=5, device=dev)
    got = channel_kernel.symbols(shape, **kw)
    assert torch.equal(got.cpu(), channel_kernel.symbols_plain(shape, **kw).cpu())
    g = torch.Generator(device=dev)
    g.manual_seed(shape[1])
    words = torch.randint(0, 2**32, shape, generator=g, dtype=torch.int64,
                          device=dev)
    got = channel_kernel.symbols(words=words)
    assert torch.equal(got, channel_kernel.symbols_plain(words=words))
    assert channel_kernel.launches["channel_symbols"] == before + 2


@pytest.mark.parametrize("shape", [(1, 2), (63, 70), (1000, 1024)])
@pytest.mark.parametrize("snr_db", [-1.5, 3.0])
def test_awgn_kernel_matches_plain(dev, shape, snr_db):
    from polar_tpu_torch.ops.cuda import channel_kernel

    g = torch.Generator(device=dev)
    g.manual_seed(shape[0])
    cw = (1 - 2 * torch.randint(0, 2, shape, generator=g, device=dev)).to(torch.int8)
    words = tuple(torch.randint(0, 2**32, shape, generator=g, dtype=torch.int64,
                                device=dev) for _ in range(2))
    params = snr_params(snr_db)
    for kw in (dict(words=words), dict(seeds=(7, 9), call=3)):
        got = channel_kernel.awgn(cw, params, **kw)
        want = channel_kernel.awgn_plain(cw, params, **kw)
        # the same words; an ulp of log/sqrt between the card and torch
        # may move an LLR by one step
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and int((d != 0).sum()) <= 3


@pytest.mark.parametrize("m,rate", [(1, 0.5), (2, 0.5), (7, 0.5), (10, 0.25),
                                    (12, 0.75)])
@pytest.mark.parametrize("systematic", [True, False])
def test_encoder_kernel_matches_plain(dev, m, rate, systematic):
    from polar_tpu_torch.ops.cuda import encode_kernel

    c = pt.make_code(m, rate=rate)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    msg = (1 - 2 * torch.randint(0, 2, (777, c.K), generator=g,
                                 device=dev)).to(torch.int8)
    want = (pt.encode_systematic if systematic else pt.encode)(c, msg)
    for bl in sorted({1, 2, max(1, m - 3), m}):
        before = encode_kernel.launches["block_encoder"]
        got = encode_kernel.make_encoder(c, systematic=systematic,
                                         block_level=bl)(msg)
        assert encode_kernel.launches["block_encoder"] == before + 1
        assert torch.equal(got, want), bl


def test_pinned_decoder_step_runs_the_draw_kernels(dev):
    from polar_tpu_torch.ops.cuda import channel_kernel, encode_kernel

    c = pt.make_code(9, rate=0.5)
    dec = make_kernel_decoder(c, output="systematic")
    counts = (channel_kernel.launches, encode_kernel.launches,
              channel_kernel.plain_calls, encode_kernel.plain_calls)
    for count in counts:
        for k in count:
            count[k] = 0
    gen = torch.Generator()
    gen.manual_seed(0)
    multi = pt.make_multi_step(c, decoder=dec, device=dev)
    out = multi(gen, 0.0, 1000, 3)
    assert int(out["uncorrected_errors"]) > 0
    assert channel_kernel.launches == {"channel_symbols": 3, "channel_awgn": 3}
    assert encode_kernel.launches == {"block_encoder": 3}
    assert max(channel_kernel.plain_calls.values()) == 0
    assert encode_kernel.plain_calls["encode_plain"] == 0
    # on the same words the kernel draws count what the plain versions on
    # the card (and the torch encoder) count
    bits = pt.ber.make_step_body(c, decoder=dec, rng="kernel-bits", device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    words = tuple(torch.randint(0, 2**32, (1000, cols), generator=g,
                                dtype=torch.int64, device=dev)
                  for cols in (c.K, c.N, c.N))
    got = bits(None, -1.0, 1000, words=words)
    msg = channel_kernel.symbols_plain(words=words[0])
    cw = pt.encode_systematic(c, msg)
    llr = channel_kernel.awgn_plain(cw, snr_params(-1.0), words=words[1:])
    want = pt.ber.frame_counters(msg, cw, llr, dec(llr))
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


def test_profile_step_reports_device_time(dev):
    from polar_tpu_torch.ber import chain_steps
    from polar_tpu_torch.utils.profile_step import profile_steps

    c = pt.make_code(8, rate=0.5)
    gen = torch.Generator()
    gen.manual_seed(0)
    multi = chain_steps(pt.make_step(c, decoder=make_kernel_decoder(
        c, output="systematic"), device=dev))
    lines = profile_steps(multi, gen, 512, 2)
    assert "kernels, device busy" in lines[0] and "% idle" in lines[0]
    report = "\n".join(lines)
    # the decoder (the tile kernel) takes most of the step; only the top
    # rows are listed
    assert "tile_decoder_kernel" in lines[2] and "aten::" in report


def _inject(dev, n, batch, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    msg = (1 - 2 * torch.randint(0, 2, (n, batch), generator=g,
                                 device=dev)).to(torch.int8)
    return msg, torch.randn((n, batch), generator=g, device=dev)


# (m, batch) of the front and decode+count card tests: every level to one
# above each kernel's limit at the small batches, the large ones where N * B
# stays within 2^26 elements (the plain versions' int64 and float32
# temporaries)
_ROW_BATCHES = (1, 3, 31, 4099, 32768)


def _shapes(levels):
    return [(m, b) for m in levels for b in _ROW_BATCHES
            if b <= 31 or (1 << m) * b <= 1 << 26]


@pytest.mark.parametrize(
    "m,batch", _shapes(range(2, step_kernel.FRONT_ROWS_MAX_LEVEL + 2)))
def test_front_whole_kernel_matches_plain(dev, m, batch):
    """The row-word front (style "rows") against the plain version and the
    thread kernel it replaced (style "thread"), inject and native; each
    launch counted by its kernel, the thread kernel apart."""
    c = pt.make_code(m, rate=0.5)
    msg, nrm = _inject(dev, c.N, batch, m)
    params = snr_params(-1.0)
    rows = m <= step_kernel.FRONT_ROWS_MAX_LEVEL
    before = (step_kernel.launches["front_whole"],
              step_kernel.earlier_launches["front_whole_thread"])
    for kw in (dict(msg_t=msg, normals_t=nrm),
               dict(seeds=(8, 9), call=3, batch=batch, device=dev)):
        got = step_kernel.front(c.frozen, params, **kw)
        old = step_kernel.front(c.frozen, params, style="thread", **kw)
        want = step_kernel.front_plain(c.frozen, params, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, old))
        assert torch.equal(got[1], want[1])
        if "msg_t" in kw:
            assert torch.equal(got[0], want[0])
        else:
            # the same words; an ulp of torch's log/sqrt against the card's
            # may move an LLR of the plain version by one step
            d = (got[0].int() - want[0].int()).abs()
            assert int(d.max()) <= 1 and int((d != 0).sum()) <= 3
        del got, old, want
    assert (step_kernel.launches["front_whole"],
            step_kernel.earlier_launches["front_whole_thread"]) == (
        before[0] + 2 * rows, before[1] + 4 - 2 * rows)


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [3, 8, 12])
def test_front_rows_every_warp_count_matches_plain(dev, warps, m):
    """Any warps a CTA give the thread kernel's front, with word stores
    (B % 4 == 0) and byte stores (an odd batch; inputs off a 4-byte
    line)."""
    c = pt.make_code(m, rate=0.5)
    params = snr_params(0.5)
    for batch in (4096, 4097):
        kw = dict(seeds=(m, warps), call=1, batch=batch, device=dev)
        got = step_kernel.front(c.frozen, params, warps=warps, **kw)
        want = step_kernel.front(c.frozen, params, style="thread", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    msg, nrm = _inject(dev, c.N + 1, 4096, m)
    msg = msg.view(-1)[1:c.N * 4096 + 1].view(c.N, 4096)   # 1 byte off
    nrm = nrm[:c.N].contiguous()
    assert msg.is_contiguous() and msg.data_ptr() % 4 == 1
    got = step_kernel.front(c.frozen, params, msg_t=msg, normals_t=nrm,
                            warps=warps)
    want = step_kernel.front_plain(c.frozen, params, msg_t=msg, normals_t=nrm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [3, 8, 10])
def test_decode_count_tile_every_warp_count_matches_plain(dev, warps, m):
    """Any tiles a block give the plain counts, at a ragged batch and at
    one from COUNT_BIG_BATCH."""
    c = pt.make_code(m, rate=0.5)
    program = pt.compile_program(c)
    for batch in (4099, step_kernel.COUNT_BIG_BATCH):
        llr = _tie_llrs(dev, c.N, batch, m + warps)
        cw = step_kernel.front(c.frozen, snr_params(0.0), seeds=(m, 1),
                               batch=batch, device=dev)[1]
        got = step_kernel.decode_count(program, c.frozen, llr, cw,
                                       warps=warps)
        assert torch.equal(got, step_kernel.decode_count_plain(
            program, c.frozen, llr, cw))


@pytest.mark.parametrize(
    "m,batch", _shapes(range(2, decoder_kernel.WHOLE_MAX_LEVEL + 2)))
def test_decode_count_kernel_matches_plain(dev, m, batch):
    """The tile decode+count (style "ssa") against the plain version and
    the walk it replaced (style "walk") on full-range and on tie-heavy
    LLRs; each launch counted by its kernel, the walk apart."""
    c = pt.make_code(m, rate=0.5)
    msg, _ = _inject(dev, c.K, batch, m)
    cw = pt.encode_systematic(c, msg.t()).t().contiguous()
    program = pt.compile_program(c)
    tile = m <= decoder_kernel.WHOLE_MAX_LEVEL
    for llr in (_llrs(dev, c.N, max(batch, 2), batch)[:, :batch].contiguous(),
                _tie_llrs(dev, c.N, 2 * batch, m)[:, batch:].contiguous()):
        before = (step_kernel.launches["decode_count"],
                  step_kernel.earlier_launches["decode_count_walk"])
        got = step_kernel.decode_count(program, c.frozen, llr, cw)
        old = step_kernel.decode_count(program, c.frozen, llr, cw,
                                       style="walk")
        assert (step_kernel.launches["decode_count"],
                step_kernel.earlier_launches["decode_count_walk"]) == (
            before[0] + tile, before[1] + 2 - tile)
        want = step_kernel.decode_count_plain(program, c.frozen, llr, cw)
        assert torch.equal(got, want) and torch.equal(old, want)


@pytest.mark.parametrize("m", [3, 9, 12])
@pytest.mark.parametrize("systematic", [True, False])
def test_front_chains_count_what_the_fused_step_counts(dev, m, systematic):
    c = pt.make_code(m, rate=0.5)
    kw = dict(seeds=(m, 5), call=0, batch=2000, device=dev)
    want = step_kernel.step(pt.compile_program(c), c.frozen, snr_params(0.0),
                            systematic, **kw)
    branches = (("whole", "block-whole", "block-hybrid", "block-interp")
                if systematic else ("block-whole", "block-hybrid"))
    for branch in branches:
        for mode in ("kernel", "torch"):
            chain = pt.ber.make_front_chain(c, systematic=systematic,
                                            branch=branch, middle_mode=mode)
            got = chain(snr_params(0.0), **kw)
            assert torch.equal(got, want), (branch, mode)


@pytest.mark.parametrize("m,blocks", [(11, (10, 10)), (11, (4, 7)),
                                      (11, (1, 11)), (11, (11, 11)),
                                      (12, (2, 9)), (5, (1, 1))])
@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("batch", [1, 63, 1000, 4099])
def test_middle_kernel_matches_plain(dev, m, blocks, systematic, batch):
    from polar_tpu_torch.ops.cuda import front_kernel

    c = pt.make_code(m, rate=0.5)
    x, _ = _inject(dev, c.N, batch, batch)
    blk_a, blk_b = (1 << b for b in blocks)
    keep = x.clone()
    got = front_kernel.middle_kernel(x, c.frozen, blk_a, blk_b, systematic)
    want = front_kernel.middle_plain(x, c.frozen, blk_a, blk_b, systematic)
    assert torch.equal(got, want)
    assert torch.equal(x, keep)                     # the input is not changed
    # an input that does not start on a 4-byte boundary takes the byte path
    buf = torch.empty(c.N * batch + 1, dtype=torch.int8, device=dev)
    buf[1:] = x.view(-1)
    odd = buf[1:].view(c.N, batch)
    assert torch.equal(front_kernel.middle_kernel(odd, c.frozen, blk_a, blk_b,
                                                  systematic), want)


# -- the scratch and interpreter styles ---------------------------------------


@pytest.mark.parametrize("m", [2, 7, 10, 11])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_scratch_decoder_matches_plain(dev, m, batch):
    c = pt.make_code(m, rate=0.5)
    llr = _llrs(dev, c.N, max(batch, 2), m)[:, :batch].contiguous()
    program = pt.compile_program(c)
    before = dict(decoder_kernel.launches)
    plain = dict(decoder_kernel.plain_calls)
    got, cw = decoder_kernel.decode(program, c.frozen, llr, False, "scratch")
    assert decoder_kernel.launches["scratch_decoder"] == before["scratch_decoder"] + 1
    assert decoder_kernel.plain_calls == plain and cw is None
    want, _ = decoder_kernel.decode_plain(program, c.frozen, llr.cpu(), False)
    assert torch.equal(got.cpu(), want)
    ssa, _ = decoder_kernel.decode(program, c.frozen, llr, False)
    assert torch.equal(got, ssa)


def test_scratch_refuses_what_its_shared_memory_cannot_hold(dev):
    from polar_tpu_torch.ops.cuda import build, subtree_kernel

    big = pt.make_code(decoder_kernel.SCRATCH_MAX_LEVEL + 1, rate=0.5)
    llr = _llrs(dev, big.N, 64, 1)
    with pytest.raises(ValueError, match="shared memory"):
        decoder_kernel.decode(pt.compile_program(big), big.frozen, llr, False,
                              "scratch")
    with pytest.raises(ValueError, match="shared memory"):
        subtree_kernel.make_subtree_decoder(pt.compile_code(big),
                                            style="scratch")
    # a launch above the block's shared memory is refused and reported, by
    # the tile kernel ((32, 1) at n = 2048); so is a tile shape that was not
    # built
    c = pt.make_code(decoder_kernel.SCRATCH_MAX_LEVEL, rate=0.5)
    prog, _ = decoder_kernel.device_tables(pt.compile_program(c), c.frozen, dev)
    llr = _llrs(dev, c.N, 256, 2)
    mesg = torch.empty((c.K, 256), dtype=torch.int8, device=dev)
    lib, stream = build.load_library(), torch.cuda.current_stream(dev).cuda_stream
    args = (prog.data_ptr(), c.N, 256, llr.data_ptr(), mesg.data_ptr())
    for name, err in (
            ("polar_scratch_decode",
             lib.polar_scratch_decode(*args, 32, 1, 1, 1, stream)),
            ("polar_scratch_decode",
             lib.polar_scratch_decode(*args, 16, 1, 1, 1, stream))):
        assert err != 0, name
        with pytest.raises(RuntimeError):
            build.check(err, name)
    torch.cuda.synchronize()


@pytest.mark.parametrize("level", [4, 7, 11])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_scratch_subtree_matches_plain(dev, level, batch):
    from polar_tpu_torch.ops.cuda import subtree_kernel

    nodes = _subtree_nodes(12, level)
    assert nodes
    for node in nodes:
        n = 1 << node.level
        slot = _llrs(dev, n, max(batch, 2), level)[:, :batch].contiguous()
        fn = subtree_kernel.make_subtree_decoder(node, style="scratch")
        before = subtree_kernel.launches["scratch_subtree"]
        got = fn(slot)
        assert subtree_kernel.launches["scratch_subtree"] == before + 1
        want = subtree_kernel.decode_plain(node, [slot.cpu()])
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), node.kind
        ssa = subtree_kernel.make_subtree_decoder(node)(slot)
        for a, b in zip(got, ssa):
            assert torch.equal(a, b)


_TIES = (-128, -127, -1, 0, 1, 127)


def _tie_llrs(dev, n, b, seed):
    """Full-range int8 columns, then columns drawn from the tie-heavy
    values alone."""
    x = _llrs(dev, n, b, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    ties = torch.tensor(_TIES, dtype=torch.int8, device=dev)
    x[:, b // 2:] = ties[torch.randint(0, len(_TIES), (n, b - b // 2),
                                       generator=g, device=dev)]
    return x


_SCRATCH_WANT: dict = {}


def _scratch_want(dev, level, batch):
    """LLRs of Polar(2^level, 2^(level-1)) and the plain version's u, made
    once a (level, batch)."""
    key = (level, batch)
    if key not in _SCRATCH_WANT:
        c = pt.make_code(level, rate=0.5)
        program = pt.compile_program(c)
        llr = _tie_llrs(dev, c.N, max(batch, 2), level)[:, :batch].contiguous()
        want, _ = decoder_kernel.decode_plain(program, c.frozen, llr, False)
        _SCRATCH_WANT[key] = (c, program, llr, want)
    return _SCRATCH_WANT[key]


@pytest.mark.parametrize("shape", decoder_kernel.SCRATCH_SHAPES)
@pytest.mark.parametrize("batch", [1, 3, 31, 4096, 4099])
def test_scratch_tile_shapes_match_plain(dev, shape, batch):
    """Each tile shape, at 1 and 2 warps a block where a block holds them,
    at every level where one fits (whole code, u): equal to the plain
    version on full-range and tie-heavy LLRs."""
    wr, vw = shape
    levels = 0
    for level in range(1, decoder_kernel.SCRATCH_MAX_LEVEL + 1):
        if decoder_kernel.scratch_smem(1 << level, wr, 1) > \
                decoder_kernel.SCRATCH_SMEM_BYTES:
            continue
        c, program, llr, want = _scratch_want(dev, level, batch)
        for warps in (1, 2):
            if decoder_kernel.scratch_smem(c.N, wr, warps) > \
                    decoder_kernel.SCRATCH_SMEM_BYTES:
                continue
            got, cw = decoder_kernel.decode(program, c.frozen, llr, False,
                                            "scratch", (wr, vw, warps))
            assert cw is None and torch.equal(got, want), (level, warps)
        levels += 1
    assert levels >= 9


@pytest.mark.parametrize("shape", decoder_kernel.SCRATCH_SHAPES)
@pytest.mark.parametrize("batch", [1, 3, 31, 4096, 4099])
def test_scratch_tile_subtree_shapes_match_plain(dev, shape, batch):
    """Each shape on every composite node kind of Polar(4096, 2048) at
    levels 1..11 where it fits: u and the hard block (signum(0)'s zeros)
    equal the plain version."""
    from polar_tpu_torch.ops.cuda import subtree_kernel

    wr, vw = shape
    nodes = 0
    for level in range(1, decoder_kernel.SCRATCH_MAX_LEVEL + 1):
        if decoder_kernel.scratch_smem(1 << level, wr, 1) > \
                decoder_kernel.SCRATCH_SMEM_BYTES:
            continue
        for node in _subtree_nodes(12, level):
            slot = _tie_llrs(dev, 1 << level, max(batch, 2),
                             level)[:, :batch].contiguous()
            want = subtree_kernel.decode_plain(node, [slot])
            got = subtree_kernel.make_subtree_decoder(
                node, style="scratch", shape=(wr, vw, 1))(slot)
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a, b), (node.kind, level)
            nodes += 1
    assert nodes >= 8


def test_scratch_tile_kernel_off_the_word_and_back_to_back(dev):
    """Arrays off the 4- and 16-byte grid (row views at odd offsets) take
    the byte path; two launches queued back to back on one stream, with
    no synchronisation between, give each its own answer."""
    from polar_tpu_torch.ops.cuda import subtree_kernel

    c = pt.make_code(9, rate=0.5)
    program = pt.compile_program(c)
    b = 4096
    for off in (1, 2, 4, 8):
        buf = torch.empty(c.N * b + off, dtype=torch.int8, device=dev)
        llr = buf[off:].view(c.N, b)
        llr.copy_(_tie_llrs(dev, c.N, b, off))
        want, _ = decoder_kernel.decode_plain(program, c.frozen, llr, False)
        for wr, vw in decoder_kernel.SCRATCH_SHAPES:
            got, _ = decoder_kernel.decode(program, c.frozen, llr, False,
                                           "scratch", (wr, vw, 1))
            assert torch.equal(got, want), (off, wr)
    node = _subtree_nodes(12, 9)[0]
    buf = torch.empty(512 * 4100 + 4, dtype=torch.int8, device=dev)
    slot = buf[4:].view(512, 4100)   # on the 4-byte grid, off the 8-byte
    slot.copy_(_tie_llrs(dev, 512, 4100, 3))
    assert slot.data_ptr() % 8 == 4
    want = subtree_kernel.decode_plain(node, [slot])
    for wr, vw in decoder_kernel.SCRATCH_SHAPES:
        got = subtree_kernel.make_subtree_decoder(
            node, style="scratch", shape=(wr, vw, 1))(slot)
        for a, w in zip(got, want):
            assert torch.equal(a, w), wr
    xs = [_tie_llrs(dev, c.N, b, s) for s in (5, 6)]
    wants = [decoder_kernel.decode_plain(program, c.frozen, x, False)[0]
             for x in xs]
    torch.cuda.synchronize()
    gots = [decoder_kernel.decode(program, c.frozen, x, False, "scratch")[0]
            for x in xs]
    torch.cuda.synchronize()
    for g, w in zip(gots, wants):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m", [13, 14, 15])
def test_scratch_hybrid_matches_the_plain_hybrid(dev, m):
    """The hybrid kl9 in the scratch style (the tile kernel), u output,
    equals the eager decoder on the CPU."""
    c = pt.make_code(m, rate=0.5)
    llr = _tie_llrs(dev, c.N, 257, m)
    want = pt.make_fastssc_decoder(c, output_dtype=torch.int8).lane_major(
        llr.cpu())
    got = pt.make_fastssc_decoder(c, output_dtype=torch.int8, kernel_level=9,
                                  kernel_style="scratch").lane_major(llr)
    assert torch.equal(got.cpu(), want)


def test_scratch_styles_count_their_own_launches(dev):
    """The scratch style moves its own counter and no other, in both
    entries."""
    from polar_tpu_torch.ops.cuda import subtree_kernel

    c = pt.make_code(8, rate=0.5)
    program = pt.compile_program(c)
    llr = _llrs(dev, c.N, 100, 8)
    node = _subtree_nodes(12, 7)[0]
    slot = _llrs(dev, 128, 100, 7)
    counts = (decoder_kernel.launches, subtree_kernel.launches,
              decoder_kernel.plain_calls, subtree_kernel.plain_calls)
    for name in ("scratch_decoder", "scratch_subtree"):
        before = [dict(x) for x in counts]
        if name.endswith("decoder"):
            decoder_kernel.decode(program, c.frozen, llr, False, "scratch")
        else:
            subtree_kernel.make_subtree_decoder(node, style="scratch")(slot)
        moved = {k: x[k] - b[k] for x, b in zip(counts, before) for k in x
                 if x[k] != b[k]}
        assert moved == {name: 1}, moved


@pytest.mark.parametrize("m,kl", [(4, 2), (9, 5), (12, 10), (12, 4)])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_interp_decoder_matches_plain(dev, m, kl, batch):
    from polar_tpu_torch.ops.cuda import interp_kernel

    c = pt.make_code(m, rate=0.5)
    llr = _llrs(dev, c.N, max(batch, 2), m)[:, :batch].contiguous()
    for output in ("u", "systematic", "codeword", "both"):
        dec = interp_kernel.make_interp_decoder(c, subtree_level=kl,
                                                output=output)
        before = interp_kernel.launches["interp_decoder"]
        plain = dict(interp_kernel.plain_calls)
        got = dec.lane_major(llr)
        assert interp_kernel.launches["interp_decoder"] == before + 1
        assert interp_kernel.plain_calls == plain
        want = dec.lane_major(llr.cpu())
        ssa = make_kernel_decoder(c, output=output).lane_major(llr)
        got, want, ssa = ((x,) if output != "both" else x
                          for x in (got, want, ssa))
        for a, b, s in zip(got, want, ssa, strict=True):
            assert torch.equal(a.cpu(), b), output
            assert torch.equal(a, s), output


@pytest.mark.parametrize("m", [3, 8, 12])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_interp_decode_count_matches_plain(dev, m, batch):
    from polar_tpu_torch.ops.cuda import interp_kernel

    c = pt.make_code(m, rate=0.5)
    llr = _llrs(dev, c.N, max(batch, 2), batch)[:, :batch].contiguous()
    msg, _ = _inject(dev, c.K, batch, m)
    cw = pt.encode_systematic(c, msg.t()).t().contiguous()
    count = interp_kernel.make_interp_decode_count(c, subtree_level=5)
    before = interp_kernel.launches["interp_decode_count"]
    got = count(llr, cw)
    assert interp_kernel.launches["interp_decode_count"] == before + 1
    assert torch.equal(got.cpu(), count(llr.cpu(), cw.cpu()))
    assert torch.equal(got, step_kernel.decode_count(pt.compile_program(c),
                                                     c.frozen, llr, cw))


@pytest.mark.parametrize("level", [4, 7, 11])
@pytest.mark.parametrize("batch", [1, 63, 4099])
def test_interp_subtree_matches_plain(dev, level, batch):
    from polar_tpu_torch.ops.cuda import interp_kernel, subtree_kernel

    for node in _subtree_nodes(12, level):
        n = 1 << node.level
        slot = _llrs(dev, n, max(batch, 2), level)[:, :batch].contiguous()
        for emit_u, emit_cw in ((True, False), (True, True), (False, True)):
            for kl in (3, 10):
                fn = interp_kernel.make_interp_subtree(
                    node, emit_u=emit_u, emit_cw=emit_cw, subtree_level=kl)
                before = interp_kernel.launches["interp_subtree"]
                got = fn(slot)
                assert interp_kernel.launches["interp_subtree"] == before + 1
                want = fn(slot.cpu())
                ssa = subtree_kernel.make_subtree_decoder(
                    node, emit_u=emit_u, emit_cw=emit_cw)(slot)
                for a, b, s in zip(got, want, ssa, strict=True):
                    assert torch.equal(a.cpu(), b), (node.kind, emit_u, kl)
                    assert torch.equal(a, s)


def _interp_pair(code, output, sl):
    """The interp decoder and, to hold it against, the SSA-style kernel
    decoder (the tile kernel, or the walk above its levels)."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    return (interp_kernel.make_interp_decoder(code, subtree_level=sl,
                                              output=output),
            pt.make_kernel_decoder(code, output=output))


@pytest.mark.parametrize("m", [4, 9, 12, 15])
@pytest.mark.parametrize("sl", [3, 5, 9, 10])
@pytest.mark.parametrize("batch", [1, 3, 31, 4096, 4099])
def test_interp_tile_matches_plain(dev, m, sl, batch):
    """The tile kernel against the SSA-style kernel decoder and (B <= 31,
    m <= 12) the plain version, u / cw / both; column 0 all -128, column 1
    all zero, and every fifth LLR zero (ties)."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    c = pt.make_code(m, rate=0.5)
    llr = _llrs(dev, c.N, max(batch, 2), 100 * m + sl)[:, :batch].contiguous()
    llr[::5] = 0
    for output in ("u", "codeword", "both"):
        dec, old = _interp_pair(c, output, sl)
        before = dict(interp_kernel.launches)
        got = dec.lane_major(llr)
        assert interp_kernel.launches == {
            **before, "interp_decoder": before["interp_decoder"] + 1}
        want = old.lane_major(llr)
        got, want = ((x,) if output != "both" else x for x in (got, want))
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b), output
        if batch <= 31 and m <= 12:
            plain = dec.lane_major(llr.cpu())
            plain = plain if output == "both" else (plain,)
            for a, b in zip(got, plain, strict=True):
                assert torch.equal(a.cpu(), b), output


@pytest.mark.parametrize("m,rate,sl,grid_level", [
    (9, 0.25, 2, 4), (9, 0.75, 3, 5), (12, 0.9, 5, 6), (12, 0.5, 3, 8),
    (13, 0.5, 5, 11)])
@pytest.mark.parametrize("batch", [3, 31, 4099])
def test_interp_tile_grid_entries_match_plain(dev, m, rate, sl, grid_level,
                                              batch, monkeypatch):
    """Low grid levels, so that rate-1, REP and SPC leaves and grate1s run
    as grid entries; high- and low-rate codes, tie-heavy LLRs."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    monkeypatch.setattr(interp_kernel, "INTERP_GRID_LEVEL", grid_level)
    c = pt.make_code(m, rate=rate)
    llr = _llrs(dev, c.N, max(batch, 2), m + batch)[:, :batch].contiguous()
    llr[1::3] = 0
    for output in ("u", "codeword", "both"):
        dec, old = _interp_pair(c, output, sl)
        assert dec.schedule["grid_steps"] > 0
        got, want = dec.lane_major(llr), old.lane_major(llr)
        got, want = ((x,) if output != "both" else x for x in (got, want))
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b), output
        if batch <= 31:
            plain = dec.lane_major(llr.cpu())
            plain = plain if output == "both" else (plain,)
            for a, b in zip(got, plain, strict=True):
                assert torch.equal(a.cpu(), b), output


def _at_offset(x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` bytes into a fresh
    block (off a 16-byte boundary unless 0)."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = flat[offset:offset + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("m", [4, 9, 12, 14])
@pytest.mark.parametrize("sl", [4, 10])
@pytest.mark.parametrize("batch", [1, 63, 2048, 4099])
@pytest.mark.parametrize("offset", [0, 3])
def test_interp_decoder_frames_matches_plain(dev, m, sl, batch, offset):
    """The u decoder's frame-major entry on a card: one launch of the tile
    kernel's frame-major u track on the (B, N) LLRs as given (``offset``
    3: off a 16-byte boundary, so copied first) and nothing else, u (B, K)
    equal bit for bit to the plain version and to the element-major launch
    on the transposed LLRs; ties in every fifth row. A (B, N) view that is
    not contiguous is made contiguous."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    c = pt.make_code(m, rate=0.5)
    llr_t = _llrs(dev, c.N, max(batch, 2), 1000 * m + sl)[:, :batch]
    llr_t = llr_t.contiguous()
    llr_t[::5] = 0
    llrs = _at_offset(llr_t.t().contiguous(), offset)
    assert (llrs.data_ptr() % 16 != 0) == bool(offset)
    dec = interp_kernel.make_interp_decoder(c, subtree_level=sl)
    before = dict(interp_kernel.launches)
    plain = dict(interp_kernel.plain_calls)
    got = dec(llrs)
    assert interp_kernel.launches == {
        **before, "interp_decoder_frames": before["interp_decoder_frames"] + 1}
    assert interp_kernel.plain_calls == plain
    assert got.shape == (batch, c.K) and got.is_contiguous()
    assert torch.equal(got, dec.plain(llr_t).t())
    assert torch.equal(got, dec.lane_major(llr_t).t())
    assert torch.equal(dec(llr_t.t()), got)


def _frame_grid_codes():
    """Polar(512, .) codes whose root is a rate-1, REP or SPC leaf, a
    rate0_right or a rate1_comb node, or a branch: at grid level 4 their
    frame-major schedules read the root and write u from the grid in every
    way the kernel has (f, g, add, copy, grate1, stage, rate-1, key, flip,
    rep broadcast)."""
    n, half = 512, pt.make_code(9, rate=0.5).frozen
    rep = np.ones(n, np.uint8)
    rep[-1] = 0
    spc = np.zeros(n, np.uint8)
    spc[0] = 1
    r0_right, r1_comb = half.copy(), half.copy()
    r0_right[:n // 2] = 1
    r1_comb[n // 2:] = 0
    return {"rate1": np.zeros(n, np.uint8), "rep": rep, "spc": spc,
            "rate0_right": r0_right, "rate1_comb": r1_comb, "branch": half}


@pytest.mark.parametrize("root", sorted(_frame_grid_codes()))
@pytest.mark.parametrize("batch", [3, 31, 4099])
def test_interp_decoder_frames_grid_entries_match_plain(dev, root, batch,
                                                        monkeypatch):
    """Grid level 4, so that the frame-major schedule's grid entries read
    the (B, N) root and write u (B, K) in each way; against the plain
    version and the element-major launch, on LLRs off a 16-byte boundary
    (which the entry copies)."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    monkeypatch.setattr(interp_kernel, "INTERP_GRID_LEVEL", 4)
    c = pt.PolarCode(9, _frame_grid_codes()[root])
    llr_t = _llrs(dev, c.N, max(batch, 2), batch)[:, :batch].contiguous()
    llr_t[1::3] = 0
    dec = interp_kernel.make_interp_decoder(c, subtree_level=2)
    assert dec.schedule["grid_steps"] > 0
    before = interp_kernel.launches["interp_decoder_frames"]
    got = dec(_at_offset(llr_t.t().contiguous(), 5))
    assert interp_kernel.launches["interp_decoder_frames"] == before + 1
    assert torch.equal(got, dec.plain(llr_t).t())
    assert torch.equal(got, dec.lane_major(llr_t).t())


def test_interp_tile_subtree_in_every_hybrid_node(dev):
    """Every distinct kernel node of the m = 17 hybrid (kl9) at B = 4096:
    the tile kernel against the SSA-style subtree kernel and the plain
    version on the card, u / u+cw / cw."""
    from polar_tpu_torch.code.compiler import emit_program
    from polar_tpu_torch.ops.cuda import interp_kernel, subtree_kernel

    nodes, stack = {}, [pt.compile_code(pt.make_code(17, rate=0.5))]
    while stack:
        node = stack.pop()
        if node.level <= 9 and node.mesg_bits >= 1 and node.kind in (
                "branch", "rate0_right", "rate1_comb"):
            nodes.setdefault(emit_program(node, node.level).tobytes(), node)
            continue
        stack.extend(c for c in (node.left, node.right) if c is not None)
    assert len(nodes) > 50
    for i, node in enumerate(nodes.values()):
        slot = _llrs(dev, 1 << node.level, 4096, i)
        for emit_u, emit_cw in ((True, False), (True, True), (False, True)):
            kw = dict(emit_u=emit_u, emit_cw=emit_cw)
            fn = interp_kernel.make_interp_subtree(node, **kw)
            got = fn(slot)
            old = subtree_kernel.make_subtree_decoder(node, **kw)(slot)
            for a, b, p in zip(got, old, fn.plain(slot), strict=True):
                assert torch.equal(a, b), (node.kind, node.level, kw)
                assert torch.equal(a, p), (node.kind, node.level, kw)


def test_interp_decode_count_back_to_back(dev):
    """Decode+count twice on one stream (the counter's ticket resets
    between launches), against the tile decode+count's counters."""
    from polar_tpu_torch.ops.cuda import count_kernel, interp_kernel

    c = pt.make_code(14, rate=0.5)
    llr = _llrs(dev, c.N, 4096, 14)
    msg, _ = _inject(dev, c.K, 4096, 14)
    cw = pt.encode_systematic(c, msg.t()).t().contiguous()
    count = interp_kernel.make_interp_decode_count(c)
    before = (interp_kernel.launches["interp_decode_count"],
              count_kernel.launches["count"])
    first, second = count(llr, cw), count(llr, cw)
    assert (interp_kernel.launches["interp_decode_count"],
            count_kernel.launches["count"]) == (before[0] + 2, before[1] + 2)
    want = step_kernel.decode_count(pt.compile_program(c), c.frozen, llr, cw)
    assert torch.equal(first, want) and torch.equal(second, want)
    assert int(want[0]) > 0


def test_interp_refused_cooperative_launch_raises(dev, monkeypatch):
    """A cooperative grid larger than the card holds at once is refused
    by the runtime, and the wrapper raises (nothing falls back)."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    c = pt.make_code(12, rate=0.5)
    dec = interp_kernel.make_interp_decoder(c, subtree_level=5)
    assert dec.schedule["grid_steps"] > 0
    plan = interp_kernel._plan
    monkeypatch.setattr(interp_kernel, "_plan", lambda *a: {
        **plan(*a), "blocks": 1 << 20})
    before = dict(interp_kernel.launches)
    with pytest.raises(RuntimeError, match="polar_interp_tile"):
        dec.lane_major(_llrs(dev, c.N, 4096, 1))
    assert interp_kernel.launches == before


@pytest.mark.parametrize("style", ["scratch", "interp"])
def test_hybrid_styles_match_the_ssa_hybrid(dev, style):
    c = pt.make_code(12, rate=0.5)
    llr = _llrs(dev, c.N, 1000, 12)
    for mode in ("u", "systematic", "codeword", "both"):
        want = pt.make_fastssc_decoder(c, output=mode, output_dtype=torch.int8,
                                       kernel_level=9).lane_major(llr)
        dec = pt.make_fastssc_decoder(c, output=mode, output_dtype=torch.int8,
                                      kernel_level=9, kernel_style=style)
        got, frame = dec.lane_major(llr), dec(llr.t().contiguous())
        if mode != "both":
            got, frame, want = (got,), (frame,), (want,)
        for a, f, b in zip(got, frame, want, strict=True):
            assert torch.equal(a, b), mode
            assert torch.equal(f.t(), b), mode


@pytest.mark.parametrize("m", [4, 10, 13])
def test_block_interp_chain_counts_what_the_fused_step_counts(dev, m):
    from polar_tpu_torch.ops.cuda import interp_kernel

    c = pt.make_code(m, rate=0.5)
    kw = dict(seeds=(m, 6), call=0, batch=2000, device=dev)
    want = step_kernel.step(pt.compile_program(c), c.frozen, snr_params(0.0),
                            True, **kw)
    before = interp_kernel.launches["interp_decode_count"]
    got = pt.ber.make_front_chain(c, branch="block-interp")(snr_params(0.0),
                                                            **kw)
    assert interp_kernel.launches["interp_decode_count"] == before + 1
    assert torch.equal(got, want)


def test_torch_launch_sets_the_library_device(dev):
    """A launch on ``cuda:i`` leaves the library's own runtime on device i
    (it links the runtime statically and keeps its own current device)."""
    from polar_tpu_torch.ops.cuda import build

    c = pt.make_code(6, rate=0.5)
    program = pt.compile_program(c)
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        decoder_kernel.decode(program, c.frozen, _llrs(d, c.N, 8, i), False)
        torch.cuda.synchronize(d)
        assert build.current_device() == i


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("offset", [1, -1, 2, -2, 4])
def test_torch_ring_kernel_matches_plain(dev, n, offset):
    from polar_tpu_torch.ops.cuda import ring_kernel

    g = torch.Generator(device=dev)
    g.manual_seed(n * 10 + offset)
    payloads = [
        lambda: torch.randint(-128, 128, (64, 4099), generator=g, device=dev,
                              dtype=torch.int8),
        lambda: torch.randint(-128, 128, (2, 64, 33), generator=g, device=dev,
                              dtype=torch.int8),
        lambda: torch.randint(-128, 128, (1, 7), generator=g, device=dev,
                              dtype=torch.int8),
        lambda: torch.randn((512, 64), generator=g, device=dev),
        # unaligned views: the byte path
        lambda: torch.randint(-128, 128, (1001,), generator=g, device=dev,
                              dtype=torch.int8)[1:],
    ]
    for make in payloads:
        blocks = [make() for _ in range(n)]
        before = ring_kernel.launches["ring_shift"]
        plain_before = dict(ring_kernel.plain_calls)
        got = ring_kernel.ring_shift(blocks, offset)
        assert ring_kernel.launches["ring_shift"] == before + 1
        assert ring_kernel.plain_calls == plain_before
        want = ring_kernel.ring_shift_plain(blocks, offset)
        torch.cuda.synchronize()
        for d in range(n):
            assert got[d].device == blocks[d].device
            assert torch.equal(got[d], want[d])
            assert torch.equal(got[d], blocks[(d + offset) % n])


@pytest.mark.parametrize("batch_split", [False, True])
def test_torch_rdma_decode_matches_local_on_one_card(dev, batch_split):
    """The element-sharded decoder at Polar(4096, 2048) over 8 positions
    of one card, through the ring-shift kernel, equals the local decoder;
    its exchanges all run as kernel launches."""
    from polar_tpu_torch.ops.cuda import ring_kernel
    from polar_tpu_torch.parallel.seqpar import element_mesh
    from polar_tpu_torch.parallel.seqpar_decode import make_seqpar_decoder

    c = pt.make_code(12, rate=0.5)
    llr = _llrs(dev, c.N, 256, 12).t().contiguous()
    want = pt.make_auto_decoder(c, device=dev)[0](llr)
    mesh = element_mesh([dev] * 8)
    before = ring_kernel.launches["ring_shift"]
    plain_before = dict(ring_kernel.plain_calls)
    got = make_seqpar_decoder(c, mesh, output="u", comm="rdma",
                              batch_split=batch_split)(llr)
    assert ring_kernel.launches["ring_shift"] > before
    assert ring_kernel.plain_calls == plain_before
    assert torch.equal(got, want)
    full = make_seqpar_decoder(c, mesh, batch_split=batch_split)(llr)
    assert torch.equal(full[:, c.info_indices], want)
    assert bool((full[:, c.frozen.astype(bool)] == 1).all())


# -- the tile subtree decoder and the tile step (the tile core) -------------

def _nodes_at(level):
    """One node of each kind at this level that emits message bits (leaves
    included: a kernel takes any such node), from rate-1/4, 1/2 and 3/4
    codes a few levels up."""
    out = {}
    for m in range(level + 2, level + 5):
        for rate in (0.25, 0.5, 0.75):
            stack = [pt.compile_code(pt.make_code(m, rate=rate))]
            while stack:
                node = stack.pop()
                if node.level == level and node.mesg_bits >= 1:
                    out.setdefault(node.kind, node)
                stack.extend(c for c in (node.left, node.right)
                             if c is not None)
    return [out[k] for k in sorted(out)]


def _subtree_args(dev, n, batch, fuse, emit_cw, seed):
    slot = _llrs(dev, 2 * n, max(batch, 2), seed)[:, :batch]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    hl, cwl = (torch.randint(-1, 2, (n, batch), generator=g, device=dev,
                             dtype=torch.int8) for _ in range(2))
    if fuse is None:
        return (slot[:n].contiguous(),)
    if fuse == "f":
        return (slot.contiguous(),)
    return (slot.contiguous(), hl) + ((cwl,) if emit_cw else ())


SUBTREE_OUTPUTS = ((True, False), (True, True), (False, True))


@pytest.mark.parametrize("level", [1, 4, 7, 9, 12])
@pytest.mark.parametrize("batch", [1, 63, 4099, 16384])
def test_tile_subtree_matches_plain_and_the_walk(dev, level, batch):
    """Every fuse mode and output set, in every node kind at the level; the
    slot's column 0 is all -128 and column 1 all zero (B >= 2), the left
    hard block holds zeros."""
    from polar_tpu_torch.ops.cuda import subtree_kernel

    assert level <= subtree_kernel.TILE_SUBTREE_MAX_LEVEL
    nodes = _nodes_at(level)
    assert nodes
    for node in nodes:
        n = 1 << node.level
        for fuse in (None, "f", "g"):
            for emit_u, emit_cw in SUBTREE_OUTPUTS:
                args = _subtree_args(dev, n, batch, fuse, emit_cw, level)
                kw = dict(emit_u=emit_u, emit_cw=emit_cw, fuse=fuse)
                before = dict(subtree_kernel.launches)
                got = subtree_kernel.make_subtree_decoder(node, **kw)(*args)
                walk = subtree_kernel.make_subtree_decoder(
                    node, style="walk", **kw)(*args)
                assert subtree_kernel.launches == {
                    **before,
                    "subtree_decoder": before["subtree_decoder"] + 1,
                    "walk_subtree": before["walk_subtree"] + 1}
                want = subtree_kernel.decode_plain(node, args, **kw)
                assert len(got) == len(want) == len(walk)
                for a, b, c in zip(got, want, walk):
                    assert torch.equal(a, b), (node.kind, fuse, emit_u)
                    assert torch.equal(a, c), (node.kind, fuse, emit_u)


@pytest.mark.parametrize("style,level", [("ssa", 13), ("walk", 9)])
def test_walk_subtree_above_the_limit_and_by_name(dev, style, level):
    from polar_tpu_torch.ops.cuda import subtree_kernel

    node = _nodes_at(level)[0]
    n = 1 << node.level
    for fuse in (None, "g"):
        args = _subtree_args(dev, n, 999, fuse, True, level)
        before = dict(subtree_kernel.launches)
        got = subtree_kernel.make_subtree_decoder(
            node, emit_cw=True, fuse=fuse, style=style)(*args)
        assert subtree_kernel.launches == {
            **before, "walk_subtree": before["walk_subtree"] + 1}
        want = subtree_kernel.decode_plain(node, args, fuse=fuse, emit_cw=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tile_subtree_rows_off_the_word(dev):
    """Blocks that start off a 16-byte boundary take the byte-wise path."""
    from polar_tpu_torch.ops.cuda import subtree_kernel

    node = _nodes_at(7)[0]
    n = 1 << node.level
    big = _llrs(dev, 2 * n + 1, 4096, 7)
    slot = big.view(-1)[3:3 + 2 * n * 4093].view(2 * n, 4093)
    assert slot.data_ptr() % 16 and slot.is_contiguous()
    fn = subtree_kernel.make_subtree_decoder(node, emit_cw=True, fuse="f")
    want = subtree_kernel.decode_plain(node, (slot,), fuse="f", emit_cw=True)
    assert all(torch.equal(a, b) for a, b in zip(fn(slot), want))


@pytest.mark.parametrize("m", [2, 3, 8, 10, 12, 13])
@pytest.mark.parametrize("batch", [1, 999, 32768])
def test_tile_step_matches_plain_and_the_walk(dev, m, batch):
    """Inject mode against the plain chain; native mode against the walk
    (mc_step_kernel) on the same seeds; both modes. Above the tile's limit
    (m = 13) style "ssa" runs the walk."""
    c = pt.make_code(m, rate=0.5)
    tile = m <= step_kernel.STEP_TILE_MAX_LEVEL
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    msg = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                 device=dev)).to(torch.int8)
    nrm = torch.randn((c.N, batch), generator=g, device=dev)
    program = pt.compile_program(c)
    for systematic in (True, False):
        args = (program, c.frozen, snr_params(0.0), systematic)
        before = dict(step_kernel.launches)
        got = step_kernel.step(*args, msg_t=msg, normals_t=nrm)
        name = "mc_step" if tile else "walk_step"
        assert step_kernel.launches == {**before, name: before[name] + 1}
        assert torch.equal(got, step_kernel.step_plain(*args, msg_t=msg,
                                                       normals_t=nrm))
        kw = dict(seeds=(m, batch), call=2, batch=batch, device=dev)
        a = step_kernel.step(*args, **kw)
        b = step_kernel.step(*args, style="walk", **kw)
        assert torch.equal(a, b), (a.tolist(), b.tolist())


@pytest.mark.parametrize("m,batch", [(2, 1), (2, 999), (5, 999), (10, 1),
                                     (10, 32768), (12, 999), (13, 999)])
def test_step_bits_mode_matches_native_and_plain(dev, m, batch):
    """Bits mode (``words_t``, (2N, B) int32) on the words native mode
    draws: the native counters exactly, in both styles and modes, the
    tile step to its limit and the walk above; against the plain chain on
    the same words within phase 4's tolerance (an ulp of log/sqrt may move
    an LLR: at most 3 frames' worth of bits)."""
    from polar_tpu_torch.ops.cuda import philox

    c = pt.make_code(m, rate=0.5)
    seeds, call = (m, batch), 3
    words = philox.to_int32(philox.random_bits(seeds, call, 2 * c.N, batch,
                                               dev))
    for systematic in (True, False):
        args = (pt.compile_program(c), c.frozen, snr_params(-0.5), systematic)
        for style in step_kernel.STEP_STYLES:
            before = dict(step_kernel.launches)
            got = step_kernel.step(*args, words_t=words, style=style)
            name = ("mc_step" if style == "ssa" and m <= step_kernel.
                    STEP_TILE_MAX_LEVEL else "walk_step")
            assert step_kernel.launches == {**before, name: before[name] + 1}
            native = step_kernel.step(*args, seeds=seeds, call=call,
                                      batch=batch, device=dev, style=style)
            assert torch.equal(got, native), (got.tolist(), native.tolist())
        plain = step_kernel.step_plain(*args, words_t=words)
        assert int((got - plain).abs().max()) <= 3 * c.K


def test_step_bits_mode_checks_its_words(dev):
    c = pt.make_code(6, rate=0.5)
    args = (pt.compile_program(c), c.frozen, snr_params(0.0), True)
    for bad in (torch.zeros((2 * c.N, 8), dtype=torch.int64, device=dev),
                torch.zeros((c.N, 8), dtype=torch.int32, device=dev),
                torch.zeros((8, 2 * c.N), dtype=torch.int32, device=dev).t()):
        with pytest.raises(ValueError, match="words_t"):
            step_kernel.step(*args, words_t=bad)


def test_tile_step_counts_errors_and_rows_off_the_word(dev):
    """At a low SNR every counter moves; a batch off the 16-byte word
    still equals the walk."""
    c = pt.make_code(9, rate=0.5)
    for systematic in (True, False):
        args = (pt.compile_program(c), c.frozen, snr_params(-2.0), systematic)
        kw = dict(seeds=(5, 6), call=0, batch=4099, device=dev)
        a = step_kernel.step(*args, **kw)
        assert torch.equal(a, step_kernel.step(*args, style="walk", **kw))
        assert min(a.tolist()) > 0


# -- rows 11 and 12 redesigned: the straight-line AWGN pass and the
# bit-packed encoder, against the kernels they replaced and the plain
# versions


@pytest.mark.parametrize("cols", [2, 6, 1024, 131072])
@pytest.mark.parametrize("rows", [1, 4099])
@pytest.mark.parametrize("snr_db", [-1.5, 3.0])
def test_awgn_lines_matches_plain(dev, cols, rows, snr_db):
    from polar_tpu_torch.ops.cuda import channel_kernel

    g = torch.Generator(device=dev)
    g.manual_seed(cols + rows)
    cw = (1 - 2 * torch.randint(0, 2, (rows, cols), generator=g,
                                device=dev)).to(torch.int8)
    words = tuple(torch.randint(0, 2**32, (rows, cols), generator=g,
                                dtype=torch.int64, device=dev)
                  for _ in range(2))
    params = snr_params(snr_db)
    for kw in (dict(words=words), dict(seeds=(7, 9), call=3)):
        before = channel_kernel.launches["channel_awgn"]
        got = channel_kernel.awgn(cw, params, **kw)
        assert channel_kernel.launches["channel_awgn"] == before + 1
        want = channel_kernel.awgn_plain(cw, params, **kw)
        # the same words; an ulp of log/sqrt between the card and torch
        # may move an LLR by one step
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and int((d != 0).sum()) <= 3


def test_awgn_lines_takes_unaligned_tensors(dev):
    """A tensor off the 16-byte grid takes the kernel's per-element path
    with the same LLRs."""
    from polar_tpu_torch.ops.cuda import channel_kernel

    rows, cols = 37, 512
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    buf = torch.empty(rows * cols + 16, dtype=torch.int8, device=dev)
    cw = buf[4:4 + rows * cols].view(rows, cols)
    cw.copy_((1 - 2 * torch.randint(0, 2, (rows, cols), generator=g,
                                    device=dev)).to(torch.int8))
    assert cw.data_ptr() % 16 == 4
    params = snr_params(0.5)
    got = channel_kernel.awgn(cw, params, seeds=(5, 6), call=1)
    assert torch.equal(got, channel_kernel.awgn(cw.clone(), params,
                                                seeds=(5, 6), call=1))


@pytest.mark.parametrize("m", range(1, 18))
def test_bits_encoder_matches_plain_and_encode(dev, m):
    from polar_tpu_torch.ops.cuda import encode_kernel

    c = pt.make_code(m, rate=0.5)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    levels = sorted({1, 2, 5, max(1, m - 3), m} & set(range(1, m + 1)))
    for batch in (1, 33, 4099):
        msg = (1 - 2 * torch.randint(0, 2, (batch, c.K), generator=g,
                                     device=dev)).to(torch.int8)
        for systematic in (True, False):
            want = (pt.encode_systematic if systematic else pt.encode)(c, msg)
            for bl in levels:
                before = encode_kernel.launches["block_encoder"]
                got = encode_kernel.make_encoder(
                    c, systematic=systematic, block_level=bl)(msg)
                assert encode_kernel.launches["block_encoder"] == before + 1
                assert torch.equal(got, want), (batch, systematic, bl)
                assert torch.equal(got, encode_kernel.encode_plain(
                    c, msg, systematic, 1 << bl))


def test_bits_encoder_takes_a_message_off_the_word(dev):
    """A message row that starts off a 4-byte boundary (K odd, a slice of
    rows) is read through the aligned words around it."""
    from polar_tpu_torch.ops.cuda import encode_kernel

    c = pt.PolarCode(9, np.arange(512) % 3 == 0)     # K = 341, odd
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    full = (1 - 2 * torch.randint(0, 2, (34, c.K), generator=g,
                                  device=dev)).to(torch.int8)
    msg = full[1:]
    assert msg.data_ptr() % 4 == 1
    for systematic in (True, False):
        want = (pt.encode_systematic if systematic else pt.encode)(c, msg)
        got = encode_kernel.make_encoder(c, systematic=systematic)(msg)
        assert torch.equal(got, want)


def test_draw_campaign_launches_the_redesigned_kernels(dev):
    """The pinned-decoder campaign (chip_smoke.py phase 11) runs the
    straight-line AWGN pass and the bits encoder: no plain call."""
    from polar_tpu_torch.ops.cuda import channel_kernel, encode_kernel

    c = pt.make_code(10, rate=0.5)
    dec, _ = pt.make_auto_decoder(c, output="systematic", device=dev)
    counts = (channel_kernel.launches, encode_kernel.launches,
              channel_kernel.plain_calls, encode_kernel.plain_calls)
    for count in counts:
        for k in count:
            count[k] = 0
    res = pt.run_campaign(c, device=dev, decoder=dec, seed=11, batch=2048,
                          steps_per_call=4, snr_range=(-1.0, -0.8),
                          snr_step=0.2, max_frames_per_point=4 * 2048,
                          measure_throughput=False)
    steps = sum(p.frames for p in res.points) // 2048
    assert steps == 8
    assert channel_kernel.launches == {"channel_symbols": steps,
                                       "channel_awgn": steps}
    assert encode_kernel.launches == {"block_encoder": steps}
    assert max(channel_kernel.plain_calls.values()) == 0
    assert encode_kernel.plain_calls["encode_plain"] == 0


# -- row 9 redesigned: kernels A and B on row words of 32 frames, against
# the plain versions


def _front_counts(front_kernel):
    return (front_kernel.launches["front_blocks_a"],
            front_kernel.launches["front_blocks_b"])


@pytest.mark.parametrize("m", range(1, 13))
def test_row_word_front_kernels_match_plain(dev, m):
    """Both kernels, inject and native, systematic and plain, at blocks
    {1, 4, 16, 2^10, N}: max abs err 0 against the plain versions (native
    LLRs included: the same box_muller on the same words). Batches 1, 33, 999, 4099 take the byte route, 36 and 4096
    the word route (36 with a ragged last group of 32)."""
    from polar_tpu_torch.ops.cuda import front_kernel

    c = pt.make_code(m, rate=0.5)
    blocks = sorted({1, 4, 16, 1 << 10, c.N} & {1 << i for i in range(m + 1)})
    params = snr_params(-1.0)
    for batch in (1, 33, 36, 999, 4096, 4099):
        g = torch.Generator(device=dev)
        g.manual_seed(m * 10000 + batch)
        msg = (1 - 2 * torch.randint(0, 2, (c.N, batch), generator=g,
                                     device=dev)).to(torch.int8)
        nrm = torch.randn((c.N, batch), generator=g, device=dev)
        for blk in blocks:
            for systematic in (True, False):
                for kw in (dict(msg_t=msg), dict(seeds=(5, 6), call=2,
                                                 batch=batch, device=dev)):
                    before = _front_counts(front_kernel)
                    got = front_kernel.msg_blocks(c.frozen, blk, systematic,
                                                  **kw)
                    a, b_ = before
                    assert _front_counts(front_kernel) == (a + 1, b_)
                    want = front_kernel.msg_blocks_plain(c.frozen, blk,
                                                         systematic, **kw)
                    assert torch.equal(got, want), (batch, blk, systematic)
            for kw in (dict(normals_t=nrm), dict(seeds=(5, 6), call=2)):
                before = _front_counts(front_kernel)
                got = front_kernel.chan_blocks(msg, blk, params, **kw)
                assert _front_counts(front_kernel) == (before[0],
                                                       before[1] + 1)
                want = front_kernel.chan_blocks_plain(msg, blk, params, **kw)
                assert torch.equal(got[1], want[1]), (batch, blk, list(kw))
                assert torch.equal(got[0], want[0]), (batch, blk, list(kw))


def test_row_word_front_kernels_take_unaligned_tensors(dev):
    """Rows that start off a 4-byte boundary take the byte route with the
    same result as aligned rows and the plain versions."""
    from polar_tpu_torch.ops.cuda import front_kernel

    c = pt.make_code(10, rate=0.5)
    n, batch = c.N, 64
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    buf = torch.empty(n * batch + 8, dtype=torch.int8, device=dev)
    x = buf[1:1 + n * batch].view(n, batch)
    x.copy_((1 - 2 * torch.randint(0, 2, (n, batch), generator=g,
                                   device=dev)).to(torch.int8))
    assert x.data_ptr() % 4 == 1
    for blk in (4, 1 << 10):
        got = front_kernel.chan_blocks(x, blk, snr_params(0.0), seeds=(1, 2))
        for want in (front_kernel.chan_blocks(x.clone(), blk, snr_params(0.0),
                                              seeds=(1, 2)),
                     front_kernel.chan_blocks_plain(x, blk, snr_params(0.0),
                                                    seeds=(1, 2))):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        for systematic in (True, False):
            got = front_kernel.msg_blocks(c.frozen, blk, systematic, msg_t=x)
            assert torch.equal(got, front_kernel.msg_blocks(
                c.frozen, blk, systematic, msg_t=x.clone()))
            assert torch.equal(got, front_kernel.msg_blocks_plain(
                c.frozen, blk, systematic, msg_t=x))


@pytest.mark.parametrize("systematic", [True, False])
def test_front_blocks_styles_agree(dev, systematic):
    """front_blocks on the card, with either middle, gives the plain
    versions' outputs on the CPU, native, at Polar(16384, 8192)."""
    from polar_tpu_torch.ops.cuda import front_kernel

    c = pt.make_code(14, rate=0.5)
    kw = dict(seeds=(3, 4), call=1, batch=1000)
    want = front_kernel.front_blocks(c.frozen, snr_params(-1.2), systematic,
                                     device="cpu", **kw)
    assert len(want) == (2 if systematic else 3)
    for mode in ("kernel", "torch"):
        got = front_kernel.front_blocks(c.frozen, snr_params(-1.2),
                                        systematic, device=dev,
                                        middle_mode=mode, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), mode


def test_front_campaign_launches_the_row_word_kernels(dev):
    """A campaign through make_step's default path on the block front
    (Polar(16384, 8192), B = 4096) launches kernels A and B once a step:
    no plain call."""
    from polar_tpu_torch.ops.cuda import front_kernel

    c = pt.make_code(14, rate=0.5)
    assert pt.ber._step_path(c, torch.int8, None, None, "auto", dev,
                             batch=4096) == "front"
    for count in (front_kernel.launches, front_kernel.plain_calls):
        for k in count:
            count[k] = 0
    res = pt.run_campaign(c, device=dev, seed=14, batch=4096,
                          steps_per_call=2, snr_range=(-1.4, -1.4),
                          max_frames_per_point=2 * 4096,
                          measure_throughput=False)
    steps = sum(p.frames for p in res.points) // 4096
    assert steps == 2
    assert front_kernel.launches["front_blocks_a"] == steps
    assert front_kernel.launches["front_blocks_b"] == steps
    assert max(front_kernel.plain_calls.values()) == 0


# -- rows 7 and 10 redesigned: the counter on 16 frames a lane over row
# chunks with a one-launch fold, and 16 symbols a thread from PhiloxFrame,
# against the plain versions


def _count_code(m, k):
    """Polar(2^m, k) by reliability, or the rate-1/2 code."""
    return pt.make_code(m, k) if k is not None else pt.make_code(m, rate=0.5)


def _count_inputs(dev, n, batch, seed):
    """(llr, cw, hat): full-range LLRs with a -128 and a zero column, ±1
    codewords, and estimates with some zeros and some flipped signs."""
    llr = _llrs(dev, n, max(batch, 2), seed)[:, :batch].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    cw = (1 - 2 * torch.randint(0, 2, (n, batch), generator=g,
                                device=dev)).to(torch.int8)
    hat = cw.clone()
    flips = torch.randint(0, 64, (n, batch), generator=g, device=dev)
    hat[flips == 0] = 0
    hat[flips == 1] *= -1
    return llr, cw, hat


def _count_both(c, llr, cw, hat):
    """The rows kernel, checked to launch once, and the plain version."""
    from polar_tpu_torch.ops.cuda import count_kernel

    before = count_kernel.launches["count"]
    got = count_kernel.count(c.frozen, llr, cw, hat)
    assert count_kernel.launches["count"] == before + 1
    return got, count_kernel.count_plain(c.frozen, llr, cw, hat)


@pytest.mark.parametrize("m,k", [(1, None), (2, None), (11, None), (11, 1),
                                 (11, 2047), (14, None)])
@pytest.mark.parametrize("batch", [1, 15, 16, 17, 33, 511, 512, 513, 4096,
                                   4099])
def test_count_rows_matches_plain(dev, m, k, batch):
    c = _count_code(m, k)
    llr, cw, hat = _count_inputs(dev, c.N, batch, m + batch)
    got, want = _count_both(c, llr, cw, hat)
    assert got.dtype == torch.int64 and got.shape == (5,)
    assert torch.equal(got, want), (got.tolist(), want.tolist())


@pytest.mark.parametrize("batch", [16, 4096, 4099])
def test_count_rows_takes_tensors_off_the_word(dev, batch):
    """Tensors at a storage offset of 1 take the kernel's byte loads."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(11, rate=0.5)
    llr, cw, hat = _count_inputs(dev, c.N, batch, batch)
    moved = []
    for t in (llr, cw, hat):
        buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=dev)
        x = buf[1:].view(c.N, batch)
        x.copy_(t)
        assert x.data_ptr() % 16 == (t.data_ptr() + 1) % 16 != 0
        moved.append(x)
    got, moved_plain = _count_both(c, *moved)
    assert torch.equal(got, count_kernel.count_plain(c.frozen, llr, cw, hat))
    assert torch.equal(moved_plain, got)


def test_count_rows_frame_errors_across_chunks(dev):
    """A frame whose only error lies in the first row chunk, another whose
    only error lies in the last, errors at frozen rows (unread), then an
    all-zero estimate."""
    from polar_tpu_torch.ops.cuda import count_kernel

    m, batch = 14, 4096
    frozen = np.arange(1 << m) % 3 == 2          # rows 1 and N - 1 are info
    c = pt.PolarCode(m, frozen)
    _, chunks, rows = count_kernel.count_plan(
        c.N, batch, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert chunks > 2 and rows > 1
    llr, cw, _ = _count_inputs(dev, c.N, batch, 3)
    hat = cw.clone()
    hat[1, 5] *= -1                              # chunk 0, group 0
    hat[c.N - 1, batch - 1] *= -1                # the last chunk and group
    hat[2, :] = 0                                # a frozen row
    got, want = _count_both(c, llr, cw, hat)
    assert got.tolist()[:3] == [2, 2, 0]
    assert torch.equal(got, want)
    zero = torch.zeros_like(hat)
    got, want = _count_both(c, llr, cw, zero)
    assert got.tolist()[:3] == [c.K * batch, batch, c.K * batch]
    assert torch.equal(got, want)


def test_count_rows_back_to_back(dev):
    """Two launches in a row on one stream, no synchronisation between:
    the ticket and the scratch serve both."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(14, rate=0.5)
    a = _count_inputs(dev, c.N, 4096, 1)
    b = _count_inputs(dev, c.N, 4096, 2)
    before = count_kernel.launches["count"]
    got = [count_kernel.count(c.frozen, *a), count_kernel.count(c.frozen, *b),
           count_kernel.count(c.frozen, *a)]
    assert count_kernel.launches["count"] == before + 3
    want_a = count_kernel.count_plain(c.frozen, *a)
    want_b = count_kernel.count_plain(c.frozen, *b)
    assert not torch.equal(want_a, want_b)
    assert torch.equal(got[0], want_a) and torch.equal(got[2], want_a)
    assert torch.equal(got[1], want_b)


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (63, 70), (1000, 512),
                                   (65537, 16), (3, 65540), (7, 1536),
                                   (5, 4608)])
def test_symbols_lines_matches_plain(dev, shape):
    from polar_tpu_torch.ops.cuda import channel_kernel

    g = torch.Generator(device=dev)
    g.manual_seed(sum(shape))
    words = torch.randint(0, 2**32, shape, generator=g, dtype=torch.int64,
                          device=dev)
    for kw in (dict(words=words), dict(seeds=(12, 34), call=5)):
        args = () if "words" in kw else (shape,)
        dev_kw = {} if "words" in kw else dict(device=dev)
        before = channel_kernel.launches["channel_symbols"]
        got = channel_kernel.symbols(*args, **kw, **dev_kw)
        assert channel_kernel.launches["channel_symbols"] == before + 1
        want = channel_kernel.symbols_plain(*args, **kw, **dev_kw)
        assert got.shape == shape and got.dtype == torch.int8
        assert torch.equal(got, want)


def test_symbols_lines_takes_words_off_the_word(dev):
    """A words tensor one int64 off the 16-byte grid takes the kernel's
    per-element path with the same symbols."""
    from polar_tpu_torch.ops.cuda import channel_kernel

    rows, cols = 37, 512
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    buf = torch.randint(0, 2**32, (rows * cols + 1,), generator=g,
                        dtype=torch.int64, device=dev)
    words = buf[1:].view(rows, cols)
    assert words.data_ptr() % 16 == 8
    got = channel_kernel.symbols(words=words)
    assert torch.equal(got, channel_kernel.symbols_plain(words=words))
    assert torch.equal(got, channel_kernel.symbols(words=words.clone()))


def test_front_campaign_launches_the_row_counter(dev):
    """A campaign on the block front (Polar(16384, 8192), B = 4096) counts
    each step with the rows kernel: no plain call."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(14, rate=0.5)
    for count in (count_kernel.launches, count_kernel.plain_calls):
        for k in count:
            count[k] = 0
    res = pt.run_campaign(c, device=dev, seed=15, batch=4096,
                          steps_per_call=2, snr_range=(-1.4, -1.4),
                          max_frames_per_point=2 * 4096,
                          measure_throughput=False)
    steps = sum(p.frames for p in res.points) // 4096
    assert steps == 2
    assert count_kernel.launches == {"count": steps, "count_frames": 0}
    assert count_kernel.plain_calls == {"count_plain": 0,
                                        "count_frames_plain": 0}


# -- the draws path's u-domain counter (csrc/count.cu count_frames_kernel)


def _frame_count_inputs(dev, batch, k, n, seed):
    """(message, codeword, llrs, decoded) frame-major int8 on the card:
    ±1 message and codeword, full-range LLRs and estimates with about 10 %
    zeros and the values -128 and 0; frame 0 right, frame 1 all wrong."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int8)

    msg = 1 - 2 * rand((batch, k), 0, 2)
    cw = 1 - 2 * rand((batch, n), 0, 2)
    llr, dec = rand((batch, n)), rand((batch, k))
    for t in (llr, dec):
        t[rand(t.shape, 0, 10) == 0] = 0
        t.view(-1)[::7] = -128
    dec[0] = msg[0]
    if batch > 1:
        dec[1] = -msg[1]
    return msg, cw, llr, dec


def _off_the_word(t):
    """The same values at a storage offset of one byte."""
    buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=t.device)
    x = buf[1:].view(t.shape)
    x.copy_(t)
    assert x.data_ptr() % 16 == (t.data_ptr() + 1) % 16 != 0
    return x


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("batch", [1, 4097, 4096])
@pytest.mark.parametrize("m", [4, 10, 14])
def test_count_frames_matches_plain(dev, m, batch, aligned):
    """The kernel == its plain version (max abs err 0) on the 16-byte
    path and, at a one-byte offset, the byte path; m = 4 (K = 8) takes
    the byte path either way. One launch a call."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(m, rate=0.5)
    t = _frame_count_inputs(dev, batch, c.K, c.N, 100 * m + batch)
    want = count_kernel.count_frames_plain(*t)
    if not aligned:
        t = tuple(_off_the_word(x) for x in t)
    before = count_kernel.launches["count_frames"]
    got = count_kernel.count_frames(*t)
    assert count_kernel.launches["count_frames"] == before + 1
    assert got.dtype == torch.int64 and got.shape == (5,)
    assert int((got - want).abs().max()) == 0, (got.tolist(), want.tolist())
    if batch > 1:
        assert min(want.tolist()) > 0


def test_count_frames_back_to_back_and_every_frame_wrong(dev):
    """Three launches on one stream with no synchronisation between (the
    ticket and a fresh scratch each), one launch each; an all-zero
    estimate makes every frame a frame error."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(14, rate=0.5)
    a = _frame_count_inputs(dev, 4096, c.K, c.N, 1)
    b = _frame_count_inputs(dev, 4096, c.K, c.N, 2)
    before = count_kernel.launches["count_frames"]
    got = [count_kernel.count_frames(*a), count_kernel.count_frames(*b),
           count_kernel.count_frames(*a)]
    assert count_kernel.launches["count_frames"] == before + 3
    want_a, want_b = (count_kernel.count_frames_plain(*x) for x in (a, b))
    assert not torch.equal(want_a, want_b)
    assert torch.equal(got[0], want_a) and torch.equal(got[2], want_a)
    assert torch.equal(got[1], want_b)
    zero = torch.zeros_like(a[3])
    got = count_kernel.count_frames(*a[:3], zero)
    assert got.tolist()[:3] == [4096 * c.K, 4096, 4096 * c.K]


def test_count_frames_grid_is_one_resident_wave(dev):
    """The runtime holds some CTAs of each instance on an SM; the byte
    instance, with more registers, no more than the 16-byte one. A batch
    of more frame units than a wave counts right on a grid of one wave."""
    from polar_tpu_torch.ops.cuda import count_kernel

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    straight = count_kernel.frame_wave(dev, True)
    byte = count_kernel.frame_wave(dev, False)
    assert straight % sms == 0 and byte % sms == 0
    assert sms <= byte <= straight <= 8 * sms
    c = pt.make_code(10, rate=0.5)    # a warp a frame: a unit a frame
    batch = 2 * count_kernel.FRAME_WARPS * straight + 5
    _, blocks = count_kernel.count_frames_plan(batch, c.K, c.N, straight)
    assert blocks == straight
    t = _frame_count_inputs(dev, batch, c.K, c.N, 7)
    assert torch.equal(count_kernel.count_frames(*t),
                       count_kernel.count_frames_plain(*t))


@pytest.mark.parametrize("m,batch", [(10, 32768), (11, 32768), (12, 4096)])
def test_make_step_plain_mid_levels_take_the_draws(dev, monkeypatch, m,
                                                   batch):
    """``make_step``'s own plain step where ``AUTO_STEP_PATH`` names the
    draws: one step on the draws path, one count_frames launch, and the
    counters frame_counters gives on the step's own tensors."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(m, rate=0.5)
    step = pt.make_step(c, systematic=False, device=dev)
    seen = []
    real = count_kernel.count_frames

    def spy(*t):
        seen.append(t)
        return real(*t)

    monkeypatch.setattr(count_kernel, "count_frames", spy)
    gen = torch.Generator()
    gen.manual_seed(m)
    draws = pt.ber.steps_by_path["draws"]
    before = count_kernel.launches["count_frames"]
    got = {k: int(v) for k, v in step(gen, -1.0, batch).items()}
    assert pt.ber.steps_by_path["draws"] == draws + 1
    assert count_kernel.launches["count_frames"] == before + 1
    want = {k: int(v) for k, v in pt.ber.frame_counters(*seen[-1]).items()}
    assert got == want and got["awgn_errors"] > 0


def test_draws_step_counts_what_the_torch_counters_count(dev, monkeypatch):
    """The kernel-draws step at non-systematic m = 14, B = 64 around the
    auto u decoder: one count_frames launch a step, and its counters equal
    frame_counters on the step's own tensors, on three seeds."""
    from polar_tpu_torch.ops.cuda import count_kernel

    c = pt.make_code(14, rate=0.5)
    dec, _ = pt.make_auto_decoder(c, output="u", output_dtype=torch.int8,
                                  device=dev)
    step = pt.ber.make_step_body(c, systematic=False, rng="kernel",
                                 decoder=dec, device=dev)
    seen = []
    real = count_kernel.count_frames

    def spy(*t):
        seen.append(t)
        return real(*t)

    monkeypatch.setattr(count_kernel, "count_frames", spy)
    for seed in (1, 2, 3):
        gen = torch.Generator()
        gen.manual_seed(seed)
        before = count_kernel.launches["count_frames"]
        got = {k: int(v) for k, v in step(gen, -1.5, 64).items()}
        assert count_kernel.launches["count_frames"] == before + 1
        want = {k: int(v) for k, v in pt.ber.frame_counters(*seen[-1]).items()}
        assert got == want, seed
        assert got["uncorrected_errors"] > 0 and got["awgn_errors"] > 0


# -- the tile kernels' frame-major u track: (B, N) LLRs in, (B, K) out

_FRAME_BATCHES = (1, 7, 8, 37, 4099, 32768)
_EDGES = (-128, -1, 0, 1, 127)


def _frame_arms():
    """(style, shape, m): the tile kernel at every level it serves, each
    scratch shape at every level where one warp's tile fits a block."""
    arms = [("ssa", None, m)
            for m in range(1, decoder_kernel.WHOLE_MAX_LEVEL + 1)]
    for wr, vw in decoder_kernel.SCRATCH_SHAPES:
        for m in range(1, decoder_kernel.SCRATCH_MAX_LEVEL + 1):
            fit = decoder_kernel.SCRATCH_SMEM_BYTES // \
                decoder_kernel.scratch_smem(1 << m, wr, 1)
            if fit:
                arms.append(("scratch", (wr, vw, min(2, fit)), m))
    return arms


def _frame_llrs(dev, n, b, seed):
    """Frame-major (B, N) int8: even frames drawn from the edge values,
    odd frames full-range."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-128, 128, (b, n), generator=g, device=dev,
                      dtype=torch.int8)
    edges = torch.tensor(_EDGES, dtype=torch.int8, device=dev)
    x[::2] = edges[torch.randint(0, len(_EDGES), x[::2].shape, generator=g,
                                 device=dev)]
    return x


def _frames_key(style):
    return ("scratch_decoder_frames" if style == "scratch"
            else "fastssc_decoder_u_frames")


@pytest.mark.parametrize("style,shape,m", _frame_arms())
def test_frame_major_u_track_matches_the_transposed_lane_major(dev, style,
                                                               shape, m):
    """The frame-major launch equals the element-major one on the
    transposed LLRs, transposed back, bit for bit, at every batch of
    _FRAME_BATCHES (tails of 1-7 frames, one tile, many), and counts one
    launch under its own key."""
    c = pt.make_code(m, rate=0.5)
    program = pt.compile_program(c)
    for b in _FRAME_BATCHES:
        llrs = _frame_llrs(dev, c.N, b, 1000 * m + b)
        want, _ = decoder_kernel.decode(program, c.frozen,
                                        llrs.t().contiguous(), False, style,
                                        shape)
        before = dict(decoder_kernel.launches)
        got, cw = decoder_kernel.decode(program, c.frozen, llrs, False, style,
                                        shape, layout="frames")
        key = _frames_key(style)
        assert decoder_kernel.launches == {**before, key: before[key] + 1}
        assert cw is None and got.shape == (b, c.K)
        assert torch.equal(got, want.t()), b
        if b == 37:
            plain, _ = decoder_kernel.decode_plain(
                program, c.frozen, llrs.t().contiguous(), False)
            assert torch.equal(got, plain.t())


@pytest.mark.parametrize("style", ["ssa", "scratch"])
def test_frame_major_u_track_off_the_word(dev, style):
    """LLR views that start off every 16-byte boundary read the same."""
    c = pt.make_code(8, rate=0.5)
    program = pt.compile_program(c)
    b = 4099
    want = None
    for off in (0, 1, 2, 4, 8):
        buf = torch.empty(b * c.N + off, dtype=torch.int8, device=dev)
        llrs = buf[off:].view(b, c.N)
        llrs.copy_(_frame_llrs(dev, c.N, b, 8))
        assert (llrs.data_ptr() % 16 == 0) == (off == 0)
        got, _ = decoder_kernel.decode(program, c.frozen, llrs, False, style,
                                       layout="frames")
        if want is None:
            want = decoder_kernel.decode(program, c.frozen,
                                         llrs.t().contiguous(), False,
                                         style)[0].t()
        assert torch.equal(got, want), off


@pytest.mark.parametrize("m,style", [(6, "ssa"), (10, "ssa"), (13, "ssa"),
                                     (6, "scratch"), (10, "scratch")])
def test_frame_major_entry_runs_no_transpose(dev, m, style):
    """The kernel decoder's frame-major entry on the u track: one launch
    under the frame-major key a call, the span ``decode`` over the
    kernel's span and no ``decode.transpose_*``; the same answer as the
    element-major entry."""
    from torch.profiler import ProfilerActivity, profile

    from polar_tpu_torch.utils import profiling

    c = pt.make_code(m, rate=0.5)
    dec = make_kernel_decoder(c, style=style)
    llrs = _frame_llrs(dev, c.N, 32768, m)
    key = _frames_key(style)
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        before = dict(decoder_kernel.launches)
        got = dec(llrs)
        after = dict(decoder_kernel.launches)
    spans, _ = profiling.take_spans()
    assert after == {**before, key: before[key] + 1}
    assert [s[0] for s in spans] == ["decode", f"kernel.{key}"]
    assert torch.equal(got, dec.lane_major(llrs.t().contiguous()).t())


def test_auto_decoder_takes_the_frame_major_kernel_at_the_bench_code(dev):
    """make_auto_decoder at Polar(1024, 512), u, at both batches of its
    choice: the frame-major launch and no copy span; the cw outputs keep
    their transposes, and the interpreter's u track (Polar(8192, 4096))
    takes its own frame-major launch."""
    from torch.profiler import ProfilerActivity, profile

    from polar_tpu_torch.utils import profiling

    c = pt.make_code(10, rate=0.5)
    dec, _ = pt.make_auto_decoder(c, device=dev)
    sys_dec, _ = pt.make_auto_decoder(c, output="systematic", device=dev)
    big = pt.make_auto_decoder(pt.make_code(13, rate=0.5), device=dev)[0]
    for b, key in ((4096, "fastssc_decoder_u_frames"),
                   (32768, "scratch_decoder_frames")):
        llrs = _frame_llrs(dev, c.N, b, b)
        profiling.take_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            got = dec(llrs)
        spans, _ = profiling.take_spans()
        assert [s[0] for s in spans] == ["decode", f"kernel.{key}"], b
        assert torch.equal(got, dec.lane_major(llrs.t().contiguous()).t())
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        sys_dec(_frame_llrs(dev, c.N, 64, 3))
    names = [s[0] for s in profiling.take_spans()[0]]
    assert "decode.transpose_in" in names and "decode.transpose_out" \
        in names, names
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        big(_frame_llrs(dev, 1 << 13, 64, 3))
    names = [s[0] for s in profiling.take_spans()[0]]
    assert names == ["decode", "kernel.interp_decoder_frames"], names


# -- the float32 u track (decoder_kernel.decode_f32, csrc/decoder.cu) ------

def _float_reference():
    """``perfbench/reference/float32.py``, the benchmark's plain float
    Fast-SSC (it imports nothing of the program)."""
    import sys
    from pathlib import Path

    bench = str(Path(__file__).resolve().parents[1] / "perfbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from reference import float32

    return float32


def _float_llrs(dev, n, b, seed):
    """float32 (B, N) LLRs with the float decode's edge cases planted: a
    frame all -0.0, one all +0.0, one of small integers (exact-zero
    repetition sums and g updates, signed zeros), one of magnitudes from
    {0.5, 1, 1.5} (tied SPC minima); the rest normal, a third of their
    entries ±0.0."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((b, n), generator=g, device=dev) * 2.5
    zero = torch.rand((b, n), generator=g, device=dev) < 1 / 3
    neg = torch.rand((b, n), generator=g, device=dev) < 0.5
    signed_zero = torch.where(neg, -0.0, 0.0)
    x = torch.where(zero, signed_zero, x)
    small = torch.randint(-2, 3, (b, n), generator=g, device=dev).float()
    small = torch.where(small == 0, signed_zero, small)
    tie = torch.randint(1, 4, (b, n), generator=g, device=dev).float() / 2
    tie = torch.where(neg, -tie, tie)
    rows = (torch.full((n,), -0.0, device=dev), torch.zeros(n, device=dev),
            small[2 % b], tie[3 % b])
    for f, row in enumerate(rows[:b]):
        x[f] = row
    if b > 8:
        x[4:b // 2:2] = small[4:b // 2:2]
        x[5:b // 2:2] = tie[5:b // 2:2]
    return x.contiguous()


@pytest.mark.parametrize("m", [6, 7, 8, 9, 10])
@pytest.mark.parametrize("batch", [1, 33, 4097, 32768])
def test_f32_kernel_matches_the_reference_and_eager(dev, m, batch):
    """The float kernel equals the eager float decoder and the benchmark's
    float reference bit for bit, one launch a call, on the planted ±0,
    zero-sum and tie frames."""
    ref = _float_reference()
    c = pt.make_code(m, rate=0.5)
    program = pt.compile_program(c)
    llrs = _float_llrs(dev, c.N, batch, 100 * m + batch)
    before = dict(decoder_kernel.launches)
    got = decoder_kernel.decode_f32(program, c.frozen, llrs)
    assert decoder_kernel.launches == {
        **before, "f32_decoder_frames": before["f32_decoder_frames"] + 1}
    eager = pt.make_fastssc_decoder(c, output="u", output_dtype=torch.int8)
    want = ref.Decoder(c.frozen).decode(llrs.t()).t()
    assert torch.equal(got, eager(llrs))
    assert torch.equal(got, want)
    if batch >= 4:
        assert (got[:4] == 0).any()


@pytest.mark.parametrize("m", [1, 4, 9, 11, 12, decoder_kernel.F32_MAX_LEVEL])
def test_f32_kernel_tiles_and_levels(dev, m):
    """Every tile width at the smallest and largest levels it takes
    (``decoder_kernel.f32_tile``), against the eager float decoder."""
    c = pt.make_code(m, rate=0.5)
    program = pt.compile_program(c)
    llrs = _float_llrs(dev, c.N, 999, m)
    got = decoder_kernel.decode_f32(program, c.frozen, llrs)
    eager = pt.make_fastssc_decoder(c, output="u", output_dtype=torch.int8)
    assert torch.equal(got, eager(llrs))


def test_f32_kernel_off_the_word(dev):
    """LLR views that start off a 16-byte boundary (by 4, 8 and 12 bytes)
    read the same."""
    c = pt.make_code(10, rate=0.5)
    program = pt.compile_program(c)
    b = 4099
    src = _float_llrs(dev, c.N, b, 10)
    want = decoder_kernel.decode_f32(program, c.frozen, src)
    for off in (1, 2, 3):
        buf = torch.empty(b * c.N + off, dtype=torch.float32, device=dev)
        llrs = buf[off:].view(b, c.N)
        llrs.copy_(src)
        assert llrs.data_ptr() % 16 != 0
        assert torch.equal(
            decoder_kernel.decode_f32(program, c.frozen, llrs), want), off


def test_f32_kernel_refuses_above_its_level(dev):
    c = pt.make_code(decoder_kernel.F32_MAX_LEVEL + 1, rate=0.5)
    with pytest.raises(ValueError, match="N <="):
        decoder_kernel.decode_f32(pt.compile_program(c), c.frozen,
                                  torch.zeros((2, c.N), device=dev))


def test_auto_decoder_routes_by_dtype(dev):
    """make_auto_decoder's u track on a card: float32 (B, N) LLRs take one
    launch of the float kernel under the spans ``decode`` and
    ``kernel.f32_decoder_frames``; int8 LLRs the kernels they took before;
    the cw outputs in float32 and float32 above the kernel's level run the
    eager float decoder, which launches nothing; other float dtypes,
    float32 that is not 2-D and element-major float32 on the kernel's
    track raise."""
    from torch.profiler import ProfilerActivity, profile

    from polar_tpu_torch.utils import profiling

    c = pt.make_code(10, rate=0.5)
    dec, desc = pt.make_auto_decoder(c, device=dev)
    eager = pt.make_fastssc_decoder(c, output="u", output_dtype=torch.int8)
    llrs = _float_llrs(dev, c.N, 32768, 3)
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        before = dict(decoder_kernel.launches)
        got = dec(llrs)
        after = dict(decoder_kernel.launches)
    spans, _ = profiling.take_spans()
    assert after == {**before, "f32_decoder_frames":
                     before["f32_decoder_frames"] + 1}
    assert [s[0] for s in spans] == ["decode", "kernel.f32_decoder_frames"]
    assert torch.equal(got, eager(llrs))
    for b, key in ((4096, "fastssc_decoder_u_frames"),
                   (32768, "scratch_decoder_frames")):
        q = _frame_llrs(dev, c.N, b, b)
        before = dict(decoder_kernel.launches)
        dec(q)
        assert dict(decoder_kernel.launches) == {**before,
                                                 key: before[key] + 1}
    sys_dec, _ = pt.make_auto_decoder(c, output="systematic", device=dev)
    big = pt.make_code(decoder_kernel.F32_MAX_LEVEL + 1, rate=0.5)
    big_dec, _ = pt.make_auto_decoder(big, device=dev)
    before = dict(decoder_kernel.launches)
    for bad in (llrs[:64].double(), llrs[:64].half(), llrs[:64].bfloat16(),
                llrs[:64].reshape(64, 2, -1)):
        with pytest.raises(ValueError, match="2-D float32"):
            dec(bad)
    with pytest.raises(ValueError, match="frame-major"):
        dec.lane_major(llrs[:64].t().contiguous())
    sys_want = pt.make_fastssc_decoder(c, output="systematic",
                                       output_dtype=torch.int8)(llrs[:64])
    assert torch.equal(sys_dec(llrs[:64]), sys_want)
    assert torch.equal(sys_dec.lane_major(llrs[:64].t().contiguous()),
                       sys_want.t())
    big_llrs = torch.randn((3, big.N), device=dev)
    assert torch.equal(big_dec(big_llrs), pt.make_fastssc_decoder(
        big, output="u", output_dtype=torch.int8)(big_llrs))
    assert dict(decoder_kernel.launches) == before


# -- the tile core's register block (fastssc_simd.cuh, tile_stages.py) -----

def _edge_codes(level):
    """Three codes of 2^level rows whose REP, SPC and rate-1 nodes take
    every length from N/4 down to 4, two nodes a length and each kind at
    each length in one of the three (the rest rate-0): every tile shape's
    register block edge, and twice it, among them."""
    from polar_tpu_torch.code.construction import PolarCode

    n = 1 << level
    kinds = ("rate1", "rep", "spc")
    codes = []
    for shift in range(3):
        frozen = np.ones(n, np.uint8)
        pos, j, s = 0, shift, n // 4
        while s >= 4:
            for _ in range(2):
                kind, node = kinds[j % 3], frozen[pos:pos + s]
                node[:] = 0                # rate-1
                if kind == "rep":          # all frozen but the last
                    node[:-1] = 1
                elif kind == "spc":        # the first frozen
                    node[0] = 1
                j, pos = j + 1, pos + s
            s //= 2
        codes.append(PolarCode(level, frozen))
    return codes


def test_tile_block_rows_match_the_host(dev):
    """Each instance's register block on the card is the host's
    (``tile_stages.block_rows``, the counter's)."""
    from polar_tpu_torch.ops.cuda import tile_stages

    assert tile_stages.device_block_rows(dev) == {
        s: tile_stages.block_rows(*s[:2]) for s in tile_stages.SHAPES}


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("kernel", ["tile", "scratch", "decode_count",
                                    "tile_step", "f32"])
def test_register_block_edges_match_plain(dev, kernel, shift):
    """Every changed tile kernel, bit for bit against its plain version,
    on codes whose rate-1, SPC and REP nodes straddle each shape's
    register block (lengths from 4 to N/4), on tie-heavy LLRs at a ragged
    batch: the tile decoder (u, cw, frame-major u), the scratch kernel at
    every shape (element- and frame-major), decode+count, the tile step
    (both modes), the float kernel at each of its tile widths."""
    batch = 2051
    levels = {"tile": (11,), "scratch": (9, 11), "decode_count": (11, 13),
              "tile_step": (11, 12), "f32": (9, 11, 12)}[kernel]
    for level in levels:
        c = _edge_codes(level)[shift]
        program = pt.compile_program(c)
        llr = _tie_llrs(dev, c.N, batch, 7 * level + shift)
        llrs = llr.t().contiguous()
        if kernel == "tile":
            for want_cw in (False, True):
                got = decoder_kernel.decode(program, c.frozen, llr, want_cw)
                want = decoder_kernel.decode_plain(program, c.frozen, llr,
                                                   want_cw)
                assert torch.equal(got[0], want[0])
                assert not want_cw or torch.equal(got[1], want[1])
            got, _ = decoder_kernel.decode(program, c.frozen, llrs, False,
                                           layout="frames")
            assert torch.equal(got, want[0].t())
        elif kernel == "scratch":
            want = decoder_kernel.decode_plain(program, c.frozen, llr,
                                               False)[0]
            for wr, vw in decoder_kernel.SCRATCH_SHAPES:
                if (decoder_kernel.scratch_smem(c.N, wr, 2)
                        > decoder_kernel.SCRATCH_SMEM_BYTES):
                    continue
                for layout, x, w in (("lanes", llr, want),
                                     ("frames", llrs, want.t())):
                    got, _ = decoder_kernel.decode(
                        program, c.frozen, x, False, "scratch", (wr, vw, 2),
                        layout=layout)
                    assert torch.equal(got, w), (wr, vw, layout)
        elif kernel == "decode_count":
            msg, _ = _inject(dev, c.K, batch, level)
            cw = pt.encode_systematic(c, msg.t()).t().contiguous()
            assert torch.equal(
                step_kernel.decode_count(program, c.frozen, llr, cw),
                step_kernel.decode_count_plain(program, c.frozen, llr, cw))
        elif kernel == "tile_step":
            msg, nrm = _inject(dev, c.N, batch, level + shift)
            for systematic in (True, False):
                args = (program, c.frozen, snr_params(0.0), systematic)
                assert torch.equal(
                    step_kernel.step(*args, msg_t=msg, normals_t=nrm),
                    step_kernel.step_plain(*args, msg_t=msg, normals_t=nrm))
        else:
            x = _float_llrs(dev, c.N, batch, 11 * level + shift)
            eager = pt.make_fastssc_decoder(c, output="u",
                                            output_dtype=torch.int8)
            assert torch.equal(decoder_kernel.decode_f32(program, c.frozen,
                                                         x), eager(x))


@pytest.mark.parametrize("batch", [2048, 4096])
def test_interp_register_block_at_the_bench_code(dev, batch):
    """The interpreter at Polar(16384, 8192), sl10 (its SPC nodes of 256,
    512 and 1024 rows and REP and RATE1_COMB nodes of 128 and 256
    straddle the (2, 2) block of 128 rows), and on the three edge codes
    of 2^14 rows: the frame-major u track against the plain version, the
    cw track against the walk and decode+count against its plain
    version."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    codes = [pt.make_code(14, 8192)] + (_edge_codes(14) if batch == 2048
                                        else [])
    for i, c in enumerate(codes):
        llr_t = _tie_llrs(dev, c.N, batch, 31 * batch + i)
        llr_t[::7] = 0
        dec = interp_kernel.make_interp_decoder(c, subtree_level=10)
        assert dec.schedule["reg_stages"] > 0
        assert torch.equal(dec(llr_t.t().contiguous()), dec.plain(llr_t).t())
        if i:
            continue
        cw_dec = interp_kernel.make_interp_decoder(c, subtree_level=10,
                                                   output="codeword")
        walk = pt.make_kernel_decoder(c, output="codeword")
        cw = cw_dec.lane_major(llr_t)
        assert torch.equal(cw, walk.lane_major(llr_t))
        count = interp_kernel.make_interp_decode_count(c)
        assert torch.equal(count(llr_t, cw), count.plain(llr_t, cw))
