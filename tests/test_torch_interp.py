"""The port's interpreter decoders (``polar_tpu_torch/ops/cuda/interp_kernel.py``)
against polar_tpu's, on the CPU.

Here the wrappers run their plain version, which walks the same step words
and branch descriptors as the CUDA kernel (``csrc/interp.cu``), so these
tests hold the program and its semantics against the JAX package: the
words and branch counts equal ``_build_program``'s, and the decoders equal
JAX's interpreter kernels (Pallas in interpret mode, as
``tests/test_interp_kernel.py`` runs them) and JAX's XLA decoder, bit for
bit. Inputs are full-range and edge int8 LLRs made with numpy from a seed.
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
from polar_tpu.ops.pallas.interp_kernel import (_build_program, _info_positions,
                                                make_interp_decode_count,
                                                make_interp_decoder,
                                                make_interp_subtree)
from polar_tpu_torch import ber
from polar_tpu_torch.code.compiler import node_frozen
from polar_tpu_torch.ops.cuda import interp_kernel, step_kernel

OUTPUTS = ("u", "systematic", "codeword", "both")
TRACKS = {"u": (False, True), "systematic": (True, False),
          "codeword": (True, False), "both": (True, True)}   # (cw, u)


def _edge_llr_t(n, batch, seed):
    """Element-major (N, B) int8: half full-range, half edge values."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-128, 128, (n, batch // 2)),
        rng.choice(np.array([-128, -127, -1, 0, 1, 127]),
                   (n, batch - batch // 2)),
    ], axis=1).astype(np.int8)


def _tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("kl", [2, 4, 99])
@pytest.mark.parametrize("m", range(4, 13))
def test_program_words_match_jax(m, kl):
    jc = jpt.make_code(m, rate=0.5)
    jtree = jpt.compile_code(jc)
    tree = pt.compile_code(pt.code_from_jax(jc))
    kl = min(kl, m)
    for output in OUTPUTS:
        for root_need_hard in (False, True):
            args = (kl, *TRACKS[output], root_need_hard)
            want = _build_program(jtree, *args)
            got = interp_kernel.build_program(tree, *args)
            np.testing.assert_array_equal(got.words(kl), want.words(kl))
            assert len(got.branches) == len(want.branches)
            assert got.ones_init == want.ones_init
    desc, table = interp_kernel.tables(got)
    assert desc.shape == (len(got.branches), interp_kernel.DESC_COLS)
    assert (desc[:, 0] == interp_kernel.BODY).any()


def test_info_positions_match_jax_and_the_node_masks():
    jc = jpt.make_code(10, rate=0.5)
    jstack = [jpt.compile_code(jc)]
    stack, seen = [pt.compile_code(pt.code_from_jax(jc))], 0
    while stack:
        jnode, node = jstack.pop(), stack.pop()
        pos = interp_kernel.info_positions(node, 3)
        assert pos == _info_positions(jnode, 3)
        assert np.array_equal(np.asarray(pos, int) - 3,
                              np.flatnonzero(node_frozen(node) == 0))
        seen += 1
        for a, b in ((jnode.left, node.left), (jnode.right, node.right)):
            if b is not None:
                jstack.append(a)
                stack.append(b)
    assert seen > 50


def test_words_refuse_what_does_not_fit():
    tree = pt.compile_code(pt.make_code(12, rate=0.5))
    prog = interp_kernel.build_program(tree, 2, False, True)
    prog.steps.append((0, 1 << 20))
    with pytest.raises(ValueError, match="subtree_level"):
        prog.words(2)
    prog.branches = dict.fromkeys(range(1 << 16))
    with pytest.raises(ValueError, match="branch"):
        prog.words(2)


@pytest.mark.parametrize("m,kl,outputs", [(6, 3, OUTPUTS),
                                          (8, 4, ("systematic", "both"))])
def test_interp_decoder_matches_jax_interp_kernel(m, kl, outputs):
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    llr_t = _edge_llr_t(jc.N, 128, m)
    for output in outputs:
        jdec = make_interp_decoder(jc, subtree_level=kl, output=output,
                                   interpret=True)
        want = _tuple(jdec.lane_major(jnp.asarray(llr_t)))
        dec = interp_kernel.make_interp_decoder(code, subtree_level=kl,
                                                output=output)
        assert (dec.program_steps, dec.program_branches) == (
            jdec.program_steps, jdec.program_branches)
        got = _tuple(dec.lane_major(torch.from_numpy(llr_t)))
        frame = _tuple(dec(torch.from_numpy(llr_t.T.copy())))
        for a, f, b in zip(got, frame, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(f.numpy().T, np.asarray(b))


@pytest.mark.parametrize("m", [5, 9, 10])
def test_interp_decoder_matches_jax_xla(m):
    """Every output at three subtree levels against JAX's XLA decoder."""
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    llr_t = _edge_llr_t(jc.N, 96, 50 + m)
    u, cw = jax.jit(j_fastssc(jc, output="both", output_dtype=jnp.int8)
                    .lane_major)(jnp.asarray(llr_t))
    want = {"u": (u,), "systematic": (cw[jc.info_indices],),
            "codeword": (cw,), "both": (u, cw)}
    before = dict(interp_kernel.launches)
    for kl in (2, m - 3, 10):
        for output in OUTPUTS:
            got = interp_kernel.make_interp_decoder(
                code, subtree_level=kl, output=output).lane_major(
                    torch.from_numpy(llr_t))
            for a, b in zip(_tuple(got), want[output], strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert interp_kernel.launches == before


def test_interp_decode_count_matches_jax():
    """A noisy systematic pair, as tests/test_interp_kernel.py's."""
    jc = jpt.make_code(8, rate=0.5)
    code = pt.code_from_jax(jc)
    rng = np.random.default_rng(17)
    msg = (1 - 2 * rng.integers(0, 2, (128, jc.K))).astype(np.int8)
    cw = np.asarray(jpt.encode_systematic(jc, jnp.asarray(msg)), np.int8)
    llr = np.clip(cw.astype(np.int32) * 24
                  + rng.integers(-64, 65, (128, jc.N)), -128, 127).astype(np.int8)
    llr_t, cw_t = llr.T.copy(), cw.T.copy()
    want = make_interp_decode_count(jc, subtree_level=4, frame_tile=128,
                                    interpret=True)(jnp.asarray(llr_t),
                                                    jnp.asarray(cw_t))
    count = interp_kernel.make_interp_decode_count(code, subtree_level=4)
    got = count(torch.from_numpy(llr_t), torch.from_numpy(cw_t))
    assert got.tolist() == [int(want[k]) for k in step_kernel.COUNTERS]
    assert int(got[3]) > 0 and int(got[0]) > 0
    with pytest.raises(ValueError, match="cw_t"):
        count(torch.from_numpy(llr_t), torch.from_numpy(cw_t[:4]))


def _composite_nodes(jtree, tree, levels):
    """(jax node, port node) pairs of the kinds the hybrid hands over."""
    out, stack = {}, [(jtree, tree)]
    while stack:
        jnode, node = stack.pop()
        if node.level in levels and node.mesg_bits >= 1 and node.kind in (
                "branch", "rate0_right", "rate1_comb"):
            out.setdefault((node.level, node.kind), (jnode, node))
        for a, b in ((jnode.left, node.left), (jnode.right, node.right)):
            if b is not None:
                stack.append((a, b))
    return [out[k] for k in sorted(out)]


@pytest.mark.parametrize("level,kind,kl,emit_u,emit_cw", [
    (7, "branch", 3, True, False), (5, "branch", 10, True, True),
    (5, "rate1_comb", 2, False, True), (7, "rate0_right", 4, True, True)])
def test_interp_subtree_matches_jax(level, kind, kl, emit_u, emit_cw):
    jc = jpt.make_code(9, rate=0.5)
    pairs = _composite_nodes(jpt.compile_code(jc),
                             pt.compile_code(pt.code_from_jax(jc)), (level,))
    jnode, node = next((a, b) for a, b in pairs if b.kind == kind)
    slot = _edge_llr_t(1 << level, 128, level)
    want = make_interp_subtree(jnode, interpret=True, emit_u=emit_u,
                               emit_cw=emit_cw, layout="lane",
                               subtree_level=kl)(jnp.asarray(slot))
    got = interp_kernel.make_interp_subtree(
        node, emit_u=emit_u, emit_cw=emit_cw, subtree_level=kl)(
            torch.from_numpy(slot))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _jax_xla_m9():
    """(code, llr_t, outputs by mode) from JAX's XLA decoder at m = 9."""
    jc = jpt.make_code(9, rate=0.5)
    llr_t = _edge_llr_t(jc.N, 131, 91)
    u, cw = (np.asarray(x) for x in jax.jit(j_fastssc(
        jc, output="both", output_dtype=jnp.int8).lane_major)(jnp.asarray(llr_t)))
    return jc, llr_t, {"u": (u,), "systematic": (cw[jc.info_indices],),
                       "codeword": (cw,), "both": (u, cw)}


@pytest.mark.parametrize("entry", ["lane", "frame"])
@pytest.mark.parametrize("output", OUTPUTS)
def test_interp_hybrid_matches_jax_xla(output, entry):
    jc, llr_t, wants = _jax_xla_m9()
    want = wants[output]
    dec = pt.make_fastssc_decoder(pt.code_from_jax(jc), output=output,
                                  output_dtype=torch.int8, kernel_level=6,
                                  kernel_style="interp")
    x = torch.from_numpy(llr_t)
    got = _tuple(dec.lane_major(x) if entry == "lane"
                 else dec(x.t().contiguous()))
    for a, b in zip(got, want, strict=True):
        a = a if entry == "lane" else a.t()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grate1_cw_is_the_double_transform_with_zero_llrs():
    """A rate-1-combine node above the subtree level, fed zero LLRs: its
    right half's hard estimate holds zeros, and the codeword track is
    T(T(hr)) (the re-encode of û), not hr."""
    code = pt.make_code(8, rate=0.75)
    tree = pt.compile_code(code)
    prog = interp_kernel.build_program(tree, 2, True, True)
    assert any(key[0] == "grate1" for key in prog.branches)
    llr_t = _edge_llr_t(code.N, 64, 5)
    llr_t[:, ::3] = 0
    llr_t[: code.N // 2, 1::3] = 0
    x = torch.from_numpy(llr_t)
    u, cw = interp_kernel.make_interp_decoder(code, subtree_level=2,
                                              output="both").lane_major(x)
    ref_u, ref_cw = pt.make_fastssc_decoder(code, output="both",
                                            output_dtype=torch.int8).lane_major(x)
    assert int((u == 0).sum()) > 0 and int((cw == 0).sum()) > 0
    assert torch.equal(u, ref_u) and torch.equal(cw, ref_cw)
    # with the root's hard kept, the hard track and the cw track part
    prog = interp_kernel.build_program(tree, 2, True, True, True)
    hard, cw2, _ = interp_kernel.interp_plain(
        prog.words(2), *interp_kernel.tables(prog), 8, 2, x, want_cw=True,
        want_u=True, prefill=True)
    assert torch.equal(cw2, ref_cw) and bool((hard != cw2).any())


def test_block_interp_chain_counts_what_block_hybrid_counts():
    """The block front + interpreter decode+count on injected inputs, as
    the block front + hybrid decoder + counter kernel counts them."""
    code = pt.make_code(10, rate=0.5)
    rng = np.random.default_rng(4)
    counted = []
    for snr in (-1.0, 1.0):
        msg = (1 - 2 * rng.integers(0, 2, (code.N, 96))).astype(np.int8)
        nrm = rng.standard_normal((code.N, 96), np.float32)
        kw = dict(msg_t=torch.from_numpy(msg), normals_t=torch.from_numpy(nrm))
        params = pt.channel.snr_params(snr)
        got = ber.make_front_chain(code, branch="block-interp")(params, **kw)
        want = ber.make_front_chain(code, branch="block-hybrid")(params, **kw)
        assert torch.equal(got, want), snr
        counted.append(int(got[0]))
    assert counted[0] > 0
    with pytest.raises(ValueError, match="branch"):
        ber.make_front_chain(code, systematic=False, branch="block-interp")
    assert ber.front_branch(code, True) != "block-interp"


def test_interp_refuses_fusion_and_rate0():
    code = pt.make_code(8, rate=0.5)
    with pytest.raises(ValueError, match="fusion"):
        pt.make_fastssc_decoder(code, kernel_level=5, kernel_style="interp",
                                kernel_fuse=True)
    node = pt.compile_code(code).left
    with pytest.raises(ValueError, match="fusion"):
        interp_kernel.make_interp_subtree(node, fuse="f")
    with pytest.raises(ValueError, match="emit_u"):
        interp_kernel.make_interp_subtree(node, emit_u=False)
    rate0 = pt.compile_code(pt.PolarCode(4, np.ones(16, np.uint8)))
    with pytest.raises(ValueError, match="message bits"):
        interp_kernel.make_interp_subtree(rate0)
    with pytest.raises(ValueError, match="output"):
        interp_kernel.make_interp_decoder(code, output="hard")
    with pytest.raises(ValueError, match="style"):
        pt.make_fastssc_decoder(code, kernel_level=5, kernel_style="unrolled")


@pytest.mark.parametrize("m,kl", [(6, 3), (9, 4)])
def test_interp_u_entry_on_cpu_is_the_transposing_one(m, kl):
    """On CPU tensors the u decoder's frame-major entry is the transposing
    one around the plain version, bit for bit: no launch, one plain call,
    equal to JAX's XLA decoder."""
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    llr_t = _edge_llr_t(jc.N, 96, 70 + m)
    want = jax.jit(j_fastssc(jc, output="u", output_dtype=jnp.int8)
                   .lane_major)(jnp.asarray(llr_t))
    dec = interp_kernel.make_interp_decoder(code, subtree_level=kl)
    before = dict(interp_kernel.launches)
    plain = interp_kernel.plain_calls["interp_plain"]
    got = dec(torch.from_numpy(llr_t.T.copy()))
    assert interp_kernel.launches == before
    assert interp_kernel.plain_calls["interp_plain"] == plain + 1
    assert got.shape == (96, code.K) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().T, np.asarray(want))
    frames = pt.decode.fastssc.frame_major(dec.lane_major, "interp decoder")
    assert torch.equal(got, frames(torch.from_numpy(llr_t.T.copy())))


def test_interp_frames_launch_refuses_the_cw_track():
    """The frame-major launch is the u track alone: asked for the cw track
    or the hard rows, for a code below level 6 with grid entries, or given
    LLRs that are not contiguous (B, N) int8 on 16 bytes, it raises
    ValueError before it touches a device."""
    before = dict(interp_kernel.launches)
    code = pt.make_code(6, rate=0.5)
    llrs = torch.zeros((8, code.N), dtype=torch.int8)
    for output in ("systematic", "codeword", "both"):
        c = interp_kernel.make_interp_decoder(code, subtree_level=3,
                                              output=output).compiled
        with pytest.raises(ValueError, match="u track alone"):
            interp_kernel._run_tile(c, llrs, hard_out=False, what="x",
                                    frames=True)
    c = interp_kernel.make_interp_decoder(code, subtree_level=3).compiled
    with pytest.raises(ValueError, match="u track alone"):
        interp_kernel._run_tile(c, llrs, hard_out=True, what="x", frames=True)
    flat = torch.zeros(8 * code.N + 16, dtype=torch.int8)
    for bad in (llrs.t(), llrs[:, :-1], llrs.to(torch.int16),
                torch.zeros((8, 2 * code.N), dtype=torch.int8)[:, ::2],
                flat[3:3 + 8 * code.N].view(8, code.N)):
        with pytest.raises(ValueError, match="contiguous"):
            interp_kernel._run_tile(c, bad, hard_out=False, what="x",
                                    frames=True)
    small = pt.make_code(5, rate=0.5)
    c = interp_kernel._compile(pt.compile_code(small), small.frozen, 2, False,
                               True, prefill_all=True, grid_level=4)
    assert c.sched.cooperative
    with pytest.raises(ValueError, match="level 6"):
        interp_kernel._run_tile(c, torch.zeros((8, small.N), dtype=torch.int8),
                                hard_out=False, what="x", frames=True)
    assert interp_kernel.launches == before
