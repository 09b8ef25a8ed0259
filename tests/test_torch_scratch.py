"""The port's scratch-style decoders (``csrc/scratch.cu``: the pyramid and
the hard stack in shared memory) against polar_tpu's, on the CPU.

On the CPU the scratch wrappers run the eager decoder, as the SSA ones do:
the two styles differ only in where the card keeps the pyramid. These
tests hold the wrappers' contracts (u output only, no cw block or fusion,
the shared-memory limit) and their outputs against JAX's scratch kernels
(Pallas in interpret mode, as ``tests/test_pallas.py`` runs them) and
JAX's XLA decoder, bit for bit, on full-range and edge int8 LLRs.
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
from polar_tpu.ops.pallas.decoder_kernel import (make_pallas_decoder,
                                                 make_subtree_decoder)
from polar_tpu_torch.decode.auto import make_kernel_decoder
from polar_tpu_torch.ops.cuda import decoder_kernel, subtree_kernel

OUTPUTS = ("u", "systematic", "codeword", "both")


def _edge_llr_t(n, batch, seed):
    """Element-major (N, B) int8: half full-range, half edge values."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-128, 128, (n, batch // 2)),
        rng.choice(np.array([-128, -127, -1, 0, 1, 127]),
                   (n, batch - batch // 2)),
    ], axis=1).astype(np.int8)


def _check_decoder_against_jax(m, rate, style):
    jc = jpt.make_code(m, rate=rate)
    llr_t = _edge_llr_t(jc.N, 128, m)
    want = np.asarray(make_pallas_decoder(
        jc, frame_tile=128, style="scratch", interpret=True)(
            jnp.asarray(llr_t.T.copy())))
    dec = make_kernel_decoder(pt.code_from_jax(jc), style=style)
    before = dict(decoder_kernel.launches)
    got = dec(torch.from_numpy(llr_t.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dec.lane_major(torch.from_numpy(llr_t)).numpy(), want.T)
    assert decoder_kernel.launches == before


@pytest.mark.parametrize("m,rate", [(4, 0.5), (6, 0.25), (8, 0.5),
                                    (5, 0.75), (7, 0.5), (9, 0.25)])
def test_scratch_decoder_matches_jax_scratch_kernel(m, rate):
    _check_decoder_against_jax(m, rate, "scratch")


def _nodes(tree, levels):
    out, stack = {}, [tree]
    while stack:
        node = stack.pop()
        if node.level in levels and node.mesg_bits >= 1 and node.kind in (
                "branch", "rate0_right", "rate1_comb"):
            out.setdefault((node.level, node.kind), node)
        stack.extend(c for c in (node.left, node.right) if c is not None)
    return [out[k] for k in sorted(out)]


def _check_subtree_against_jax(level, style):
    jc = jpt.make_code(8, rate=0.5)
    jnodes = _nodes(jpt.compile_code(jc), (level,))
    nodes = _nodes(pt.compile_code(pt.code_from_jax(jc)), (level,))
    assert len(nodes) == len(jnodes) >= 1
    for jnode, node in zip(jnodes, nodes):
        slot = _edge_llr_t(1 << level, 128, level)
        want = make_subtree_decoder(jnode, frame_tile=128, style="scratch",
                                    interpret=True, layout="lane")(
                                        jnp.asarray(slot))
        got = subtree_kernel.make_subtree_decoder(node, style=style)(
            torch.from_numpy(slot))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("level", [4, 7, 5, 6])
def test_scratch_subtree_matches_jax_scratch_kernel(level):
    _check_subtree_against_jax(level, "scratch")


@functools.lru_cache(maxsize=None)
def _jax_xla_m9():
    jc = jpt.make_code(9, rate=0.5)
    llr_t = _edge_llr_t(jc.N, 131, 19)
    u, cw = (np.asarray(x) for x in jax.jit(j_fastssc(
        jc, output="both", output_dtype=jnp.int8).lane_major)(jnp.asarray(llr_t)))
    return jc, llr_t, {"u": (u,), "systematic": (cw[jc.info_indices],),
                       "codeword": (cw,), "both": (u, cw)}


def _check_hybrid_against_jax(output, entry, style, kernel_level=6):
    jc, llr_t, wants = _jax_xla_m9()
    dec = pt.make_fastssc_decoder(pt.code_from_jax(jc), output=output,
                                  output_dtype=torch.int8,
                                  kernel_level=kernel_level,
                                  kernel_style=style,
                                  kernel_fuse=entry == "lane")
    x = torch.from_numpy(llr_t)
    got = dec.lane_major(x) if entry == "lane" else dec(x.t().contiguous())
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, wants[output], strict=True):
        a = a if entry == "lane" else a.t()
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("output,entry,kernel_level", [
    pytest.param(output, entry, kl,
                 id=f"{output}-{entry}" + ("" if kl == 6 else f"-kl{kl}"))
    for kl in (6, 5) for entry in ("lane", "frame") for output in OUTPUTS])
def test_scratch_hybrid_matches_jax_xla(output, entry, kernel_level):
    """kernel_fuse is ignored by the scratch style, as in JAX; non-u
    outputs re-encode û."""
    _check_hybrid_against_jax(output, entry, "scratch", kernel_level)


def test_scratch_frames_follow_the_shared_memory():
    assert decoder_kernel.SCRATCH_MAX_LEVEL == 11
    assert [decoder_kernel.scratch_frames(1 << m) for m in (1, 9, 10, 11)] == [
        128, 128, 96, 32]
    for m in (1, 6, 9, 10, 11):
        t = decoder_kernel.scratch_frames(1 << m)
        assert t % 32 == 0 and 2 * (1 << m) * t <= decoder_kernel.SCRATCH_SMEM_BYTES


_BATCHES = (1, 31, 4096, 4099, 32768)


@pytest.mark.parametrize("batch", _BATCHES)
@pytest.mark.parametrize("level", range(1, 12))
def test_scratch_shape_fits_a_block(level, batch):
    """scratch_shape picks a built shape whose block fits the 232,448
    bytes of shared memory, at least one warp, no more warps than tiles."""
    wr, vw, warps = decoder_kernel.scratch_shape(level, batch)
    assert (wr, vw) in decoder_kernel.SCRATCH_SHAPES
    assert decoder_kernel.SCRATCH_SMEM_BYTES == 232448
    assert decoder_kernel.scratch_smem(1 << level, wr, warps) <= 232448
    assert 1 <= warps <= -(-batch // (4 * wr))


@pytest.mark.parametrize("level", range(1, 12))
def test_scratch_grid_covers_the_card_at_4096(level):
    """At B = 4096 the grid has a block for every SM (132) wherever the
    batch has that many tiles, else a block a tile."""
    wr, _, warps = decoder_kernel.scratch_shape(level, 4096)
    tiles = -(-4096 // (4 * wr))
    assert -(-tiles // warps) >= min(132, tiles)


def _lane_cover(wr, vw, length):
    """A numpy model of fastssc_simd.cuh's Tile: lane l of a warp takes
    words w = l % (WR / VW) * VW .. + VW - 1 of rows r0 = l // (WR / VW),
    r0 + kPass, ... below ``length``, kPass = 32 / (WR / VW). Returns how
    often each (row, word) of a node of ``length`` rows is visited."""
    lanes_row = wr // vw
    k_pass = 32 // lanes_row
    seen = np.zeros((length, wr), dtype=np.int64)
    for lane in range(32):
        w = lane % lanes_row * vw
        for r in range(lane // lanes_row, length, k_pass):
            seen[r, w:w + vw] += 1
    return seen, k_pass


@pytest.mark.parametrize("length", [1 << k for k in range(1, 12)])
@pytest.mark.parametrize("shape", decoder_kernel.SCRATCH_SHAPES)
def test_tile_lanes_cover_every_row_word_once(shape, length):
    wr, vw = shape
    seen, k_pass = _lane_cover(wr, vw, length)
    assert (seen == 1).all()
    assert k_pass == 32 * vw // wr and k_pass in (1, 4, 8, 32)


def _frame_reads(wr, vw, n):
    """A numpy model of fastssc_simd.cuh's Tile with FRAMES: the byte
    offsets into a (4 WR, n) frame-major root that each lane's gather
    reads for every row it takes of a node of n rows (frame f + j of the
    lane at row r: (f + j) * n + r, f = 4 w). Returns the reads by pass
    and lane, ``(passes, 32, 4 vw)``, -1 where a lane has no row."""
    lanes_row = wr // vw
    k_pass = 32 // lanes_row
    passes = -(-n // k_pass)
    reads = np.full((passes, 32, 4 * vw), -1, dtype=np.int64)
    for lane in range(32):
        f = 4 * (lane % lanes_row * vw)
        for p, r in enumerate(range(lane // lanes_row, n, k_pass)):
            reads[p, lane] = (f + np.arange(4 * vw)) * n + r
    return reads


@pytest.mark.parametrize("length", [1 << k for k in range(1, 12)])
@pytest.mark.parametrize("shape", decoder_kernel.SCRATCH_SHAPES)
def test_frame_major_gathers_read_each_byte_once_in_runs(shape, length):
    """Every (frame, row) byte of a tile's frame-major root is read once,
    and in each pass the warp's bytes of one frame form one contiguous
    run: min(length, 32 VW / WR) rows."""
    wr, vw = shape
    reads = _frame_reads(wr, vw, length)
    got = np.sort(reads[reads >= 0])
    np.testing.assert_array_equal(got, np.arange(4 * wr * length))
    run = min(length, 32 * vw // wr)
    for p in reads:
        p = p[p >= 0]
        for frame in np.unique(p // length):
            rows = np.sort(p[p // length == frame])
            assert len(rows) == run
            np.testing.assert_array_equal(np.diff(rows), 1)


@pytest.mark.parametrize("style", ["ssa", "scratch"])
def test_frame_major_layout_refuses_what_the_kernel_cannot_read(style):
    """The frame-major wrapper takes a contiguous (B, N) int8 tensor on the
    u track of the tile kernels alone, on every device, and on the CPU
    gives the plain version's message transposed."""
    code = pt.make_code(6, rate=0.5)
    program = pt.compile_program(code)
    llrs = torch.from_numpy(_edge_llr_t(code.N, 40, 6).T.copy())

    def run(x, **kw):
        return decoder_kernel.decode(program, code.frozen, x,
                                     kw.pop("want_cw", False),
                                     kw.pop("style", style), layout="frames",
                                     **kw)

    for bad in (llrs[:, :32].contiguous(),           # N wrong
                llrs.to(torch.int16),                 # not int8
                llrs.t().contiguous().t(),            # strided (B, N)
                llrs[0]):                             # not 2-D
        with pytest.raises(ValueError, match="expected contiguous"):
            run(bad)
    with pytest.raises(ValueError, match="frame-major|cw track"):
        run(llrs, want_cw=True)
    with pytest.raises(ValueError, match="frame-major"):
        run(llrs, style="walk")
    with pytest.raises(ValueError, match="layout"):
        decoder_kernel.decode(program, code.frozen, llrs, False, style,
                              layout="rows")
    assert decoder_kernel.has_frames(style, code.N)
    assert not decoder_kernel.has_frames(
        "ssa", 1 << (decoder_kernel.WHOLE_MAX_LEVEL + 1))
    got, cw = run(llrs)
    want, _ = decoder_kernel.decode_plain(program, code.frozen,
                                          llrs.t().contiguous(), False)
    assert cw is None and torch.equal(got, want.t())
    assert got.is_contiguous()


def test_scratch_styles_run_plain_on_cpu():
    """On CPU tensors the scratch style runs the plain version and launches
    nothing, in both entries."""
    style = "scratch"
    code = pt.make_code(7, rate=0.5)
    node = pt.compile_code(code).left
    llr_t = torch.from_numpy(_edge_llr_t(code.N, 40, 3))
    counts = (decoder_kernel.launches, subtree_kernel.launches)
    before = [dict(c) for c in counts]
    plain = (decoder_kernel.plain_calls["decode_plain"],
             subtree_kernel.plain_calls["subtree_plain"])
    got, cw = decoder_kernel.decode(pt.compile_program(code), code.frozen,
                                    llr_t, False, style)
    assert cw is None
    want, _ = decoder_kernel.decode_plain(pt.compile_program(code),
                                          code.frozen, llr_t, False)
    assert torch.equal(got, want)
    subtree_kernel.make_subtree_decoder(node, style=style)(llr_t[:64])
    assert [dict(c) for c in counts] == before
    assert (decoder_kernel.plain_calls["decode_plain"],
            subtree_kernel.plain_calls["subtree_plain"]) == (plain[0] + 2,
                                                             plain[1] + 1)


def test_scratch_styles_refuse_alike():
    """The scratch style refuses the cw track, fusion and N above its
    shared memory alike in the whole-code decoder, the subtree decoder and
    the hybrid."""
    style = "scratch"
    code = pt.make_code(8, rate=0.5)
    node = pt.compile_code(code).left
    llr_t = torch.zeros(code.N, 4, dtype=torch.int8)
    for output in ("systematic", "codeword", "both"):
        with pytest.raises(ValueError, match="SSA"):
            make_kernel_decoder(code, output=output, style=style)
    with pytest.raises(ValueError, match="SSA"):
        decoder_kernel.decode(pt.compile_program(code), code.frozen, llr_t,
                              True, style)
    for kw in (dict(emit_cw=True), dict(fuse="f"), dict(fuse="g")):
        with pytest.raises(ValueError, match="SSA"):
            subtree_kernel.make_subtree_decoder(node, style=style, **kw)
    big = pt.make_code(12, rate=0.5)
    with pytest.raises(ValueError, match="shared memory"):
        make_kernel_decoder(big, style=style)
    with pytest.raises(ValueError, match="shared memory"):
        subtree_kernel.make_subtree_decoder(pt.compile_code(big), style=style)
    with pytest.raises(ValueError, match="shared memory"):
        pt.make_fastssc_decoder(big, kernel_level=12, kernel_style=style
                                ).lane_major(torch.zeros(big.N, 4,
                                                         dtype=torch.int8))
    with pytest.raises(ValueError, match="shared memory"):
        decoder_kernel.scratch_shape(12, 4096)


def test_scratch_refuses_what_it_cannot_do():
    code = pt.make_code(8, rate=0.5)
    node = pt.compile_code(code).left
    llr_t = torch.zeros(code.N, 4, dtype=torch.int8)
    for output in ("systematic", "codeword", "both"):
        with pytest.raises(ValueError, match="SSA"):
            make_kernel_decoder(code, output=output, style="scratch")
    with pytest.raises(ValueError, match="SSA"):
        decoder_kernel.decode(pt.compile_program(code), code.frozen, llr_t,
                              True, "scratch")
    for kw in (dict(emit_cw=True), dict(fuse="f"), dict(fuse="g")):
        with pytest.raises(ValueError, match="SSA"):
            subtree_kernel.make_subtree_decoder(node, style="scratch", **kw)
    big = pt.make_code(12, rate=0.5)
    with pytest.raises(ValueError, match="shared memory"):
        make_kernel_decoder(big, style="scratch")
    with pytest.raises(ValueError, match="shared memory"):
        decoder_kernel.decode(pt.compile_program(big), big.frozen,
                              torch.zeros(big.N, 4, dtype=torch.int8), False,
                              "scratch")
    with pytest.raises(ValueError, match="shared memory"):
        subtree_kernel.make_subtree_decoder(pt.compile_code(big),
                                            style="scratch")
    with pytest.raises(ValueError, match="shared memory"):
        pt.make_fastssc_decoder(big, kernel_level=12, kernel_style="scratch"
                                ).lane_major(torch.zeros(big.N, 4,
                                                         dtype=torch.int8))
    for fn in (lambda: make_kernel_decoder(code, style="pyramid"),
               lambda: subtree_kernel.make_subtree_decoder(node, style="x")):
        with pytest.raises(ValueError, match="style"):
            fn()


def test_auto_decoders_follow_the_measured_table():
    from polar_tpu_torch.decode import auto

    names = {"ssa", "scratch", "interp", "hybrid", "hybrid-scratch",
             "hybrid-interp"}
    for (level, cw), pair in auto.AUTO_DECODERS.items():
        assert set(pair) <= names
        if "scratch" in pair:     # the whole-code scratch kernel: u, N <= 2^11
            assert not cw and level <= decoder_kernel.SCRATCH_MAX_LEVEL
    assert auto.decoder_names(5, False) == ("ssa", "ssa")
    assert auto.decoder_names(12, True) == ("ssa", "ssa")
    assert auto.decoder_names(13, False) == ("interp", "interp")
    assert auto.decoder_names(13, True) == ("interp", "interp")
    assert auto.decoder_names(14, False) == ("interp", "interp")
    assert auto.decoder_names(17, True) == ("interp", "interp")
    assert auto.decoder_names(18, False) == ("hybrid", "hybrid")
    small, big = auto.BIG_BATCH - 1, auto.BIG_BATCH
    # the hybrid's subtree kernels take the SSA style where the table names
    # a whole-code decoder (the interpreter) or the plain hybrid
    assert [auto.kernel_style(15, False, b, True) for b in (small, big)] == [
        "ssa", "ssa"]
    assert [auto.kernel_style(14, True, b, True) for b in (small, big)] == [
        "ssa", "ssa"]
    for level in (7, 8, 9, 10, 11):
        assert [auto.kernel_style(level, False, b, False)
                for b in (small, big)] == ["ssa", "scratch"]
    assert auto.decoder_names(6, False) == ("scratch", "scratch")
    assert auto.decoder_names(12, False) == ("ssa", "ssa")
    assert auto.decoder_names(11, True) == ("ssa", "ssa")
    assert auto.kernel_style(7, False, big, True) == "ssa"
    # the whole-code decoder takes none of the hybrid's styles
    assert auto.kernel_style(13, True, big, False) == "ssa"
    assert auto.kernel_style(9, True, big, False) == "ssa"   # the tile kernel
    assert pt.make_auto_decoder(pt.make_code(10, rate=0.5),
                                device="cpu")[1] == "eager"


def test_front_chain_decoders_take_the_style_by_batch_or_by_name():
    from polar_tpu_torch import ber
    from polar_tpu_torch.channel import snr_params

    code = pt.make_code(13, rate=0.5)
    kw = dict(seeds=(13, 2), call=0, batch=16, device="cpu")
    counted = [ber.make_front_chain(code, branch="block-hybrid",
                                    kernel_style=style)(snr_params(-1.0), **kw)
               for style in (None, "ssa", "scratch", "interp")]
    for got in counted[1:]:
        assert torch.equal(got, counted[0])
    assert int(counted[0][3]) > 0
    with pytest.raises(ValueError, match="kernel_style"):
        ber.make_front_chain(code, branch="block-interp", kernel_style="ssa")
