"""The port's hybrid large-N decoder (eager top levels, subtree decoders
below ``kernel_level``) against polar_tpu, bit for bit.

On the CPU the subtree decoders run their plain versions, so these tests
hold the hybrid's routing (which nodes go to a subtree decoder, with which
fusion, in which message order) and the subtree bodies' semantics against
the JAX package. The full matrix compares with the JAX XLA decoder, which
``tests/test_hybrid.py`` holds equal to the JAX hybrid; two cases compare
with the JAX hybrid itself, its Pallas subtree kernels in interpret mode as
its own tests run them.
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
from polar_tpu_torch.code.compiler import build_tree, emit_program, node_frozen
from polar_tpu_torch.ops.arith import Int8Arith
from polar_tpu_torch.ops.cuda import decoder_kernel, subtree_kernel

OUTPUTS = ("u", "systematic", "codeword", "both")


def _llr_t(n, batch, seed):
    """Element-major full-range int8 LLRs with a -128 and a zero column."""
    x = np.random.default_rng(seed).integers(-128, 128, (n, batch)).astype(np.int8)
    x[:, 0] = -128
    x[:, 1] = 0
    return x


@functools.lru_cache(maxsize=None)
def _jax_both(m):
    """(llr_t, u (K, B), cw (N, B), info) from the JAX XLA decoder."""
    jc = jpt.make_code(m, rate=0.5)
    llr = _llr_t(jc.N, 131, m)
    u, cw = jax.jit(j_fastssc(jc, output="both",
                              output_dtype=jnp.int8).lane_major)(jnp.asarray(llr))
    return llr, np.asarray(u), np.asarray(cw), jc.info_indices


def _by_output(u, cw, info, output):
    return {"u": (u,), "systematic": (cw[info],), "codeword": (cw,),
            "both": (u, cw)}[output]


def _port_outputs(m, kl, fuse, output, entry, llr):
    code = pt.make_code(m, rate=0.5)
    dec = pt.make_fastssc_decoder(code, output=output, output_dtype=torch.int8,
                                  kernel_level=kl, kernel_fuse=fuse)
    x = torch.from_numpy(llr)
    out = dec.lane_major(x) if entry == "lane" else dec(x.t().contiguous())
    out = out if isinstance(out, tuple) else (out,)
    return tuple((o if entry == "lane" else o.t()).numpy() for o in out)


@pytest.mark.parametrize("entry", ["lane", "frame"])
@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("m,kl", [(8, 5), (8, 6), (8, 7), (9, 5), (9, 6), (9, 8)])
def test_hybrid_matches_jax(m, kl, fuse, output, entry):
    llr, u, cw, info = _jax_both(m)
    got = _port_outputs(m, kl, fuse, output, entry, llr)
    want = _by_output(u, cw, info, output)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,kl,fuse,output", [(8, 7, True, "both"),
                                              (8, 5, False, "systematic")])
def test_hybrid_matches_jax_pallas_hybrid(m, kl, fuse, output):
    """Against the JAX hybrid itself (Pallas subtree kernels, interpret
    mode): the root split with both fusions on the u + cw track, and a
    deeper unfused split on the cw track without u blocks."""
    jc = jpt.make_code(m, rate=0.5)
    llr = _llr_t(jc.N, 128, 100 + m)
    jdec = j_fastssc(jc, output=output, output_dtype=jnp.int8, kernel_level=kl,
                     kernel_frame_tile=128, kernel_interpret=True,
                     kernel_fuse=fuse)
    want = jax.jit(jdec.lane_major)(jnp.asarray(llr))
    want = tuple(np.asarray(w) for w in (want if output == "both" else (want,)))
    got = _port_outputs(m, kl, fuse, output, "lane", llr)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_hybrid_takes_any_batch_and_counts_plain_calls():
    code = pt.make_code(8, rate=0.5)
    ref = pt.make_fastssc_decoder(code, output="both", output_dtype=torch.int8)
    before = dict(subtree_kernel.plain_calls)
    launched = dict(subtree_kernel.launches)
    for batch in (1, 3, 130):
        llr = torch.from_numpy(_llr_t(code.N, max(batch, 2), batch)[:, :batch].copy())
        got = pt.make_fastssc_decoder(code, output="both", output_dtype=torch.int8,
                                      kernel_level=6).lane_major(llr)
        for a, b in zip(got, ref.lane_major(llr)):
            assert torch.equal(a, b)
    assert subtree_kernel.plain_calls["subtree_plain"] > before["subtree_plain"]
    assert subtree_kernel.launches == launched


def test_node_frozen_rebuilds_every_subtree():
    code = pt.make_code(10, rate=0.5)
    tree = pt.compile_code(code)
    assert np.array_equal(node_frozen(tree), code.frozen)
    stack, seen = [(tree, 0)], 0
    while stack:
        node, offset = stack.pop()
        mask = node_frozen(node)
        n = 1 << node.level
        assert np.array_equal(mask, code.frozen[offset:offset + n])
        assert build_tree(mask, node.level) == node
        program = emit_program(node, node.level)
        decoder_kernel.device_tables(program, mask, "cpu")  # the emitted-from check
        seen += 1
        if node.left is not None:
            stack.append((node.left, offset))
        if node.right is not None:
            stack.append((node.right, offset + n // 2))
    assert seen > 50


def test_subtree_decoder_fused_bodies_match_unfused():
    """fuse="f" equals f then the unfused body; fuse="g" equals g, the
    unfused body and the parent's combine (-128 in the parent slot)."""
    ph = Int8Arith()
    code = pt.make_code(9, rate=0.5)
    node = pt.compile_code(code).left.right          # a level-7 node
    n = 1 << node.level
    slot = torch.from_numpy(_llr_t(2 * n, 40, 9))
    rng = np.random.default_rng(3)
    hl = torch.from_numpy(rng.integers(-1, 2, (n, 40)).astype(np.int8))
    cwl = torch.from_numpy(rng.integers(-1, 2, (n, 40)).astype(np.int8))
    plain = subtree_kernel.make_subtree_decoder(node, emit_cw=True)
    fused_f = subtree_kernel.make_subtree_decoder(node, emit_cw=True, fuse="f")
    u, h, cw = plain(ph.prod(slot[:n], slot[n:]))
    for a, b in zip(fused_f(slot), (u, h, cw)):
        assert torch.equal(a, b)
    fused_g = subtree_kernel.make_subtree_decoder(node, emit_u=False, emit_cw=True,
                                                  fuse="g")
    _, h, cw = plain(ph.madd(hl, slot[:n], slot[n:]))
    gh, gcw = fused_g(slot, hl, cwl)
    assert torch.equal(gh, torch.cat([hl * h, h]))
    assert torch.equal(gcw, torch.cat([cwl * cw, cw]))


def test_hybrid_rejects_what_is_not_ported():
    code = pt.make_code(8, rate=0.5)
    # every kernel style is ported; what no style has still raises
    with pytest.raises(ValueError, match="fusion"):
        pt.make_fastssc_decoder(code, kernel_level=5, kernel_style="interp",
                                kernel_fuse=True)
    with pytest.raises(ValueError, match="style"):
        pt.make_fastssc_decoder(code, kernel_level=5, kernel_style="unrolled")
    dec = pt.make_fastssc_decoder(code, kernel_level=5, compute="float32")
    with pytest.raises(ValueError, match="int8"):
        dec.lane_major(torch.zeros(code.N, 4, dtype=torch.int8))
    with pytest.raises(ValueError):
        pt.make_fastssc_decoder(code, kernel_level=5)(torch.zeros(2, 3, code.N))
    rate0 = build_tree(np.ones(16, np.uint8), 4)
    with pytest.raises(ValueError):
        subtree_kernel.make_subtree_decoder(rate0)
    node = pt.compile_code(code).left
    with pytest.raises(ValueError):
        subtree_kernel.make_subtree_decoder(node, emit_u=False)
    with pytest.raises(ValueError):
        subtree_kernel.make_subtree_decoder(node, fuse="h")
