"""The subtree decoder's plain version and its wrapper's rules (CPU).

* ``subtree_kernel.decode_plain`` against the Pallas subtree decoder in
  interpret mode (``layout="lane"``), in every fuse mode (none, f, g) and
  output set (u, u + cw, cw alone), on tie-heavy slots drawn from
  {-128, -127, -1, 0, 1, 127} and left blocks drawn from {-1, 0, 1}: ties
  put zeros in the hard track, and the fused g reads the left child's hard
  block, zeros included;
* the tile subtree's shared-memory arithmetic and the level rule between
  it and the walk (``TILE_SUBTREE_MAX_LEVEL``);
* on CPU tensors every style runs the plain version and launches nothing.
The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.code.compiler import compile_code as j_compile_code
from polar_tpu.ops.pallas.decoder_kernel import make_subtree_decoder as j_subtree
from polar_tpu_torch.decode.fastssc import make_fastssc_decoder
from polar_tpu_torch.ops.cuda import decoder_kernel, subtree_kernel

TIES = np.array([-128, -127, -1, 0, 1, 127], dtype=np.int8)
BATCH = 128
KINDS = ("branch", "rate1_comb", "rate0_right")
OUTPUTS = {"u": (True, False), "u+cw": (True, True), "cw": (False, True)}


@functools.lru_cache(maxsize=None)
def _node_pairs(m=8):
    """(JAX node, port node) of each kernel-eligible kind at levels 3..5 of
    Polar(2^m, 2^(m-1)), found by walking both trees in step."""
    jc = jpt.make_code(m, rate=0.5)
    out, stack = {}, [(j_compile_code(jc), pt.compile_code(pt.code_from_jax(jc)))]
    while stack:
        jn, tn = stack.pop()
        assert (jn.kind, jn.level, jn.mesg_bits) == (tn.kind, tn.level,
                                                     tn.mesg_bits)
        if 3 <= tn.level <= 5 and tn.mesg_bits >= 1 and tn.kind in KINDS:
            out.setdefault(tn.kind, (jn, tn))
        stack.extend((a, b) for a, b in ((jn.left, tn.left),
                                         (jn.right, tn.right))
                     if a is not None)
    return out


def _blocks(n, fuse, emit_cw, seed):
    rng = np.random.default_rng(seed)
    slot = rng.choice(TIES, (2 * n if fuse else n, BATCH))
    if fuse != "g":
        return (slot,)
    hl = rng.integers(-1, 2, (n, BATCH)).astype(np.int8)
    assert (hl == 0).any()
    cwl = rng.integers(-1, 2, (n, BATCH)).astype(np.int8)
    return (slot, hl) + ((cwl,) if emit_cw else ())


@pytest.mark.parametrize("outputs", list(OUTPUTS))
@pytest.mark.parametrize("fuse", [None, "f", "g"])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_plain_matches_pallas_subtree_on_ties(kind, fuse, outputs):
    jnode, node = _node_pairs()[kind]
    emit_u, emit_cw = OUTPUTS[outputs]
    blocks = _blocks(1 << node.level, fuse, emit_cw, node.level + len(kind))
    want = j_subtree(jnode, frame_tile=BATCH, interpret=True, emit_cw=emit_cw,
                     emit_u=emit_u, layout="lane", fuse=fuse)(
        *(jnp.asarray(b) for b in blocks))
    got = subtree_kernel.decode_plain(
        node, [torch.from_numpy(b) for b in blocks], fuse=fuse, emit_u=emit_u,
        emit_cw=emit_cw)
    assert len(got) == len(want) == emit_u + 1 + emit_cw
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hard = got[emit_u]
    assert (hard == 0).any()        # the ties reached the hard track


def test_tile_subtree_shared_memory_and_the_level_rule():
    dk, sk = decoder_kernel, subtree_kernel
    top = sk.TILE_SUBTREE_MAX_LEVEL
    # the root on chip adds n bytes a frame to the tile kernel's 2n (u) and
    # 3n (cw)
    for m in (1, 9, top):
        n = 1 << m
        assert dk.tile_bytes(n, False, root=True) == 3 * n * dk.WHOLE_FRAMES
        assert dk.tile_bytes(n, True, root=True) == 4 * n * dk.WHOLE_FRAMES
    # the limit: the largest level at which one cw tile with its root fits
    # a block's shared memory
    assert dk.tile_bytes(1 << top, True, root=True) <= dk.SCRATCH_SMEM_BYTES
    assert dk.tile_bytes(2 << top, True, root=True) > dk.SCRATCH_SMEM_BYTES
    assert top == 12 < dk.WHOLE_MAX_LEVEL
    for level in range(1, top + 1):
        assert sk.ssa_kernel(level) == "tile"
        for cw in (False, True):
            warps = dk.tile_warps(1 << level, cw, root=True)
            assert 1 <= warps <= dk.WHOLE_MAX_WARPS
            assert (warps * dk.tile_bytes(1 << level, cw, root=True)
                    <= dk.SCRATCH_SMEM_BYTES)
    for level in (top + 1, 14, 16):
        assert sk.ssa_kernel(level) == "walk"
    # every node the hybrid launches at its default kernel level takes the
    # tile kernel
    from polar_tpu_torch.decode.auto import HYBRID_KERNEL_LEVEL
    assert sk.ssa_kernel(HYBRID_KERNEL_LEVEL) == "tile"


@pytest.mark.parametrize("style", ["ssa", "walk", "scratch"])
def test_cpu_tensors_run_plain_in_every_style(style):
    _, node = _node_pairs()["branch"]
    n = 1 << node.level
    before = dict(subtree_kernel.launches)
    plain = subtree_kernel.plain_calls["subtree_plain"]
    cases = ([(None, True, False)] if style == "scratch" else
             [(fuse, u, cw) for fuse in (None, "f", "g")
              for u, cw in OUTPUTS.values()])
    for fuse, emit_u, emit_cw in cases:
        blocks = [torch.from_numpy(b)
                  for b in _blocks(n, fuse, emit_cw, 5)]
        fn = subtree_kernel.make_subtree_decoder(
            node, emit_u=emit_u, emit_cw=emit_cw, fuse=fuse, style=style)
        got = fn(*blocks)
        want = subtree_kernel.decode_plain(node, blocks, fuse=fuse,
                                           emit_u=emit_u, emit_cw=emit_cw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert subtree_kernel.launches == before
    assert subtree_kernel.plain_calls["subtree_plain"] == plain + 2 * len(cases)


@pytest.mark.parametrize("output", ["u", "both"])
def test_walk_style_hybrid_equals_the_ssa_hybrid_on_the_cpu(output):
    """The hybrid takes the walk style by name, with boundary fusion; on
    the CPU both styles run the subtrees' plain versions."""
    code = pt.make_code(8, rate=0.5)
    llr_t = torch.from_numpy(np.random.default_rng(8).choice(TIES, (code.N, 16)))
    outs = [make_fastssc_decoder(code, output=output, output_dtype=torch.int8,
                                 kernel_level=5, kernel_style=style,
                                 kernel_fuse=True).lane_major(llr_t)
            for style in ("ssa", "walk")]
    a, b = ((o,) if output == "u" else o for o in outs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
