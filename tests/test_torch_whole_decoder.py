"""The whole-code decoder's plain version and its wrapper's rules (CPU).

* ``decoder_kernel.decode_plain`` against the Pallas SSA kernel in
  interpret mode, in all four output modes, on tie-heavy LLRs: drawn from
  {-128, -127, -1, 0, 1, 127}, so that zeros reach the hard track and the
  codeword estimate built per node differs from the root's hard decision;
* the tile kernel's shared-memory arithmetic and the level rule between
  the tile kernel and the walk (``WHOLE_MAX_LEVEL``);
* on a CPU tensor ``decode`` runs the plain version in every style and
  launches nothing.
The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.decoder_kernel import make_pallas_decoder
from polar_tpu_torch.decode.auto import make_kernel_decoder
from polar_tpu_torch.ops.cuda import decoder_kernel

TIES = np.array([-128, -127, -1, 0, 1, 127], dtype=np.int8)
BATCH = 128


def _tie_llrs(m):
    return np.random.default_rng(70 + m).choice(TIES, (BATCH, 1 << m))


@pytest.mark.parametrize("mode", ["u", "systematic", "codeword", "both"])
@pytest.mark.parametrize("m", range(2, 8))
def test_decode_plain_matches_pallas_ssa_on_ties(m, mode):
    jc = jpt.make_code(m, rate=0.5)
    c = pt.code_from_jax(jc)
    llr = _tie_llrs(m)
    lt = torch.from_numpy(np.ascontiguousarray(llr.T))
    pallas = make_pallas_decoder(jc, frame_tile=BATCH, interpret=True,
                                 style="ssa", output=mode)
    # element-major: the Pallas kernel's lane-major entry gives u, or u
    # and the codeword estimate on the cw track
    want = pallas.lane_major(jnp.asarray(llr.T))
    u, cw = decoder_kernel.decode_plain(pt.compile_program(c), c.frozen, lt,
                                        mode != "u")
    got = (u,) if mode == "u" else (u, cw)
    want = (want,) if mode == "u" else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the frame-major entries, the output mode's gather included (the
    # kernel decoder's plain version here)
    fm = make_kernel_decoder(c, output=mode)(torch.from_numpy(llr))
    wf = pallas(jnp.asarray(llr))
    for g, w in zip(*((fm, wf) if mode == "both" else ((fm,), (wf,)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ties_make_the_codeword_differ_from_the_hard_decision():
    """The per-node codeword track is not the root's hard decision: on
    these LLRs the two differ (DESIGN.md section 5's root-hard rejection),
    so the cases above hold the codeword track to it."""
    c = pt.make_code(7, rate=0.5)
    lt = torch.from_numpy(np.ascontiguousarray(_tie_llrs(7).T))
    _, cw = decoder_kernel.decode_plain(pt.compile_program(c), c.frozen, lt,
                                        True)
    hard = pt.make_fastssc_decoder(c, output="u", output_dtype=torch.int8)
    u = hard.lane_major(lt)
    assert (cw == 0).any()          # zeros from signum(0) reach the codeword
    assert torch.equal(cw, pt.encode(c, u.t().contiguous()).t())


def test_tile_shared_memory_and_the_level_rule():
    dk = decoder_kernel
    top, frames = dk.WHOLE_MAX_LEVEL, dk.WHOLE_FRAMES
    # csrc/decoder.cu builds tiles of 8 frames: two 32-bit words a row
    assert dk.SCRATCH_SMEM_BYTES == 232448 and frames == 8
    for cw in (False, True):
        assert dk.tile_bytes(1 << top, cw) == (3 if cw else 2) * frames << top
    # the limit: the largest level at which one cw tile fits a block's
    # shared memory (the u track's tile is smaller)
    for cw in (False, True):
        assert dk.tile_bytes(1 << top, cw) <= dk.SCRATCH_SMEM_BYTES
    assert dk.tile_bytes(2 << top, True) > dk.SCRATCH_SMEM_BYTES
    assert top == 13
    for m in range(1, top + 1):
        for cw in (False, True):
            warps = dk.tile_warps(1 << m, cw)
            assert 1 <= warps <= dk.WHOLE_MAX_WARPS
            assert warps * dk.tile_bytes(1 << m, cw) <= dk.SCRATCH_SMEM_BYTES
            if warps > 1:
                assert warps * dk.tile_bytes(1 << m, cw) <= dk.WHOLE_BLOCK_BYTES
        assert dk.ssa_kernel(1 << m) == "tile"
    for m in (top + 1, 14, 17):
        assert dk.ssa_kernel(1 << m) == "walk"
    assert dk.tile_warps(64, False) == dk.WHOLE_MAX_WARPS
    assert dk.tile_warps(1024, True) == 1


@pytest.mark.parametrize("style", ["ssa", "walk"])
@pytest.mark.parametrize("m", [5, 13])
def test_cpu_tensor_runs_plain_in_every_style(m, style):
    c = pt.make_code(m, rate=0.5)
    lt = torch.from_numpy(np.ascontiguousarray(_tie_llrs(m)[:8].T))
    program = pt.compile_program(c)
    before = dict(decoder_kernel.launches)
    plain = decoder_kernel.plain_calls["decode_plain"]
    for want_cw in (False, True):
        u, cw = decoder_kernel.decode(program, c.frozen, lt, want_cw, style)
        wu, wcw = decoder_kernel.decode_plain(program, c.frozen, lt, want_cw)
        assert torch.equal(u, wu) and (cw is None) == (not want_cw)
        if want_cw:
            assert torch.equal(cw, wcw)
    assert decoder_kernel.launches == before
    assert decoder_kernel.plain_calls["decode_plain"] == plain + 4


def test_unknown_style_and_cpu_selftest_raise():
    c = pt.make_code(4, rate=0.5)
    lt = torch.zeros((c.N, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="style"):
        decoder_kernel.decode(pt.compile_program(c), c.frozen, lt, False,
                              "tile")
    with pytest.raises(ValueError, match="CUDA"):
        decoder_kernel.simd_selftest("cpu")
