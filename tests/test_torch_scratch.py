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


@pytest.mark.parametrize("m,rate", [(4, 0.5), (6, 0.25), (8, 0.5)])
def test_scratch_decoder_matches_jax_scratch_kernel(m, rate):
    jc = jpt.make_code(m, rate=rate)
    llr_t = _edge_llr_t(jc.N, 128, m)
    want = np.asarray(make_pallas_decoder(
        jc, frame_tile=128, style="scratch", interpret=True)(
            jnp.asarray(llr_t.T.copy())))
    dec = make_kernel_decoder(pt.code_from_jax(jc), style="scratch")
    before = dict(decoder_kernel.launches)
    got = dec(torch.from_numpy(llr_t.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dec.lane_major(torch.from_numpy(llr_t)).numpy(), want.T)
    assert decoder_kernel.launches == before


def _nodes(tree, levels):
    out, stack = {}, [tree]
    while stack:
        node = stack.pop()
        if node.level in levels and node.mesg_bits >= 1 and node.kind in (
                "branch", "rate0_right", "rate1_comb"):
            out.setdefault((node.level, node.kind), node)
        stack.extend(c for c in (node.left, node.right) if c is not None)
    return [out[k] for k in sorted(out)]


@pytest.mark.parametrize("level", [4, 7])
def test_scratch_subtree_matches_jax_scratch_kernel(level):
    jc = jpt.make_code(8, rate=0.5)
    jnodes = _nodes(jpt.compile_code(jc), (level,))
    nodes = _nodes(pt.compile_code(pt.code_from_jax(jc)), (level,))
    assert len(nodes) == len(jnodes) >= 1
    for jnode, node in zip(jnodes, nodes):
        slot = _edge_llr_t(1 << level, 128, level)
        want = make_subtree_decoder(jnode, frame_tile=128, style="scratch",
                                    interpret=True, layout="lane")(
                                        jnp.asarray(slot))
        got = subtree_kernel.make_subtree_decoder(node, style="scratch")(
            torch.from_numpy(slot))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _jax_xla_m9():
    jc = jpt.make_code(9, rate=0.5)
    llr_t = _edge_llr_t(jc.N, 131, 19)
    u, cw = (np.asarray(x) for x in jax.jit(j_fastssc(
        jc, output="both", output_dtype=jnp.int8).lane_major)(jnp.asarray(llr_t)))
    return jc, llr_t, {"u": (u,), "systematic": (cw[jc.info_indices],),
                       "codeword": (cw,), "both": (u, cw)}


@pytest.mark.parametrize("entry", ["lane", "frame"])
@pytest.mark.parametrize("output", OUTPUTS)
def test_scratch_hybrid_matches_jax_xla(output, entry):
    """kernel_fuse is ignored by the scratch style, as in JAX; non-u
    outputs re-encode û."""
    jc, llr_t, wants = _jax_xla_m9()
    dec = pt.make_fastssc_decoder(pt.code_from_jax(jc), output=output,
                                  output_dtype=torch.int8, kernel_level=6,
                                  kernel_style="scratch",
                                  kernel_fuse=entry == "lane")
    x = torch.from_numpy(llr_t)
    got = dec.lane_major(x) if entry == "lane" else dec(x.t().contiguous())
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, wants[output], strict=True):
        a = a if entry == "lane" else a.t()
        np.testing.assert_array_equal(a.numpy(), b)


def test_scratch_frames_follow_the_shared_memory():
    assert decoder_kernel.SCRATCH_MAX_LEVEL == 11
    assert [decoder_kernel.scratch_frames(1 << m) for m in (1, 9, 10, 11)] == [
        128, 128, 96, 32]
    for m in (1, 6, 9, 10, 11):
        t = decoder_kernel.scratch_frames(1 << m)
        assert t % 32 == 0 and 2 * (1 << m) * t <= decoder_kernel.SCRATCH_SMEM_BYTES


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
    assert auto.decoder_names(13, False) == ("ssa", "hybrid")
    assert auto.decoder_names(13, True) == ("ssa", "hybrid")
    assert auto.decoder_names(14, False) == ("hybrid", "hybrid")
    small, big = auto.BIG_BATCH - 1, auto.BIG_BATCH
    assert [auto.kernel_style(15, False, b, True) for b in (small, big)] == [
        "scratch", "ssa"]
    assert [auto.kernel_style(14, True, b, True) for b in (small, big)] == [
        "ssa", "ssa"]
    assert [auto.kernel_style(7, False, b, False) for b in (small, big)] == [
        "ssa", "scratch"]
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
        ber.make_front_chain(code, branch="block-count", kernel_style="ssa")
