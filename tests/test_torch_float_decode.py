"""The float32 u decode off the card, against the benchmark's plain float
reference and the JAX package's float decoder (exact).

``make_auto_decoder`` with no card is the eager decoder, which picks float
min-sum for float LLRs (``polar_helper.hh:63-111``); on a card the same
arithmetic runs in the float kernel (``decoder_kernel.decode_f32``, whose
CPU branch is this eager decode; the kernel's own tests are in
``tests/test_torch_cuda.py``). Here, at m = 4..10 on seeded frozen sets:

* the eager float decode equals ``perfbench/reference/float32.py``, the
  benchmark's plain float Fast-SSC written from the upstream's description,
  on seeded LLRs and on planted edge cases: -0.0 and +0.0 LLRs, exact-zero
  repetition sums and tied SPC minima;
* it equals ``polar_tpu.make_fastssc_decoder(compute="float32")`` on the
  seeded LLRs;
* the auto decoder's float branches: a float32 u call on the CPU launches
  nothing, and the kernel's entry refuses what it does not take.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu_torch.ops.cuda import decoder_kernel

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import construction as ref_construction  # noqa: E402
from reference import float32 as ref_float32  # noqa: E402
from reference import polar as ref_polar  # noqa: E402

LEVELS = range(4, 11)


def _frozen(level: int, seed: int) -> np.ndarray:
    """The test bench's frozen mask of 2^level leaves at a seeded K and a
    seeded design-SNR offset."""
    rng = np.random.default_rng(1000 * level + seed)
    n = 1 << level
    k = int(rng.integers(n // 8, n - n // 8))
    return ref_construction.frozen_mask(level, k,
                                        float(rng.uniform(-3.0, 4.0)))


def _code(level: int, seed: int):
    return pt.PolarCode(level, _frozen(level, seed))


def _seeded_llrs(n: int, batch: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, (batch, n)) * rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(x.astype(np.float32))


def _reference(code, llrs):
    return ref_float32.Decoder(code.frozen).decode(llrs.t()).t()


def _auto(code):
    dec, desc = pt.make_auto_decoder(code, output="u", device="cpu")
    assert desc == "eager"
    return dec


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("seed", [1, 2])
def test_auto_decoder_equals_the_float_reference(level, seed):
    code = _code(level, seed)
    llrs = _seeded_llrs(code.N, 96, 10 * level + seed)
    got = _auto(code)(llrs)
    assert got.dtype == torch.int8 and tuple(got.shape) == (96, code.K)
    assert torch.equal(got, _reference(code, llrs))
    assert set(got.unique().tolist()) <= {-1, 0, 1}


@pytest.mark.parametrize("level", LEVELS)
def test_auto_decoder_equals_the_jax_float_decoder(level):
    code = _code(level, 3)
    llrs = _seeded_llrs(code.N, 64, 7 * level)
    jc = jpt.PolarCode(level, code.frozen)
    want = jax.jit(jpt.make_fastssc_decoder(jc, compute="float32"))(
        jnp.asarray(llrs.numpy()))
    got = _auto(code)(llrs)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int8))


def _zeros(n, b, rng):
    """Every frame all -0.0, all +0.0 or ±0.0 at random, beside LLRs of
    both signs."""
    x = rng.normal(0.0, 2.0, (b, n)).astype(np.float32)
    x[0] = -0.0
    x[1] = 0.0
    x[2] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    x[3:, ::3] = np.where(rng.random((b - 3, (n + 2) // 3)) < 0.5, -0.0, 0.0)
    return x


def _zero_sums(n, b, rng):
    """Small integers, so the repetition sums and the g updates come out
    exactly 0 often."""
    x = rng.integers(-2, 3, (b, n)).astype(np.float32)
    return np.where((x == 0) & (rng.random((b, n)) < 0.5), -0.0, x)


def _ties(n, b, rng):
    """Magnitudes from {0.5, 1, 1.5}: every SPC node's least |x| is tied."""
    mag = rng.choice(np.float32([0.5, 1.0, 1.5]), (b, n))
    return (mag * rng.choice(np.float32([-1, 1]), (b, n))).astype(np.float32)


@pytest.mark.parametrize("case,seed", [(_zeros, 1), (_zero_sums, 2),
                                       (_ties, 3)],
                         ids=["signed_zeros", "zero_sums", "tied_minima"])
def test_planted_edge_cases_equal_the_reference(case, seed):
    rng = np.random.default_rng(seed)
    for level in LEVELS:
        code = _code(level, 4)
        llrs = torch.from_numpy(case(code.N, 48, rng))
        got = _auto(code)(llrs)
        assert torch.equal(got, _reference(code, llrs)), level
        if case is _zero_sums:     # the zero bit of a zero sum shows
            assert (got == 0).any()


def test_planted_cases_reach_every_node_kind():
    """The seeded frozen sets hold every node kind the reference decodes
    below the root (so each edge case meets a repetition and an SPC
    node)."""
    kinds = set()

    def walk(node):
        if node is None:
            return
        kinds.add(node[0])
        walk(node[2])
        walk(node[3])

    for level in LEVELS:
        walk(ref_polar.tree(_frozen(level, 4)))
    assert {"rate1", "rep", "spc", "rate0_left", "rate1_right",
            "branch"} <= kinds


def test_float_kernel_entry_plain_version_and_refusals():
    """``decode_f32`` on CPU tensors is the eager decode (no launch); it
    refuses another dtype, shape or stride; its level limit is the largest
    at which one tile's 8N bytes a frame fit a block (one frame
    a tile there)."""
    code = _code(8, 5)
    program = pt.compile_program(code)
    llrs = _seeded_llrs(code.N, 33, 5)
    before = dict(decoder_kernel.launches)
    got = decoder_kernel.decode_f32(program, code.frozen, llrs)
    assert decoder_kernel.launches == before
    assert torch.equal(got, _reference(code, llrs))
    for bad in (llrs.to(torch.float64), llrs.to(torch.bfloat16),
                llrs.to(torch.int8), llrs[:, :-1].contiguous(), llrs.t(),
                llrs[0]):
        with pytest.raises(ValueError):
            decoder_kernel.decode_f32(program, code.frozen, bad)
    assert decoder_kernel.F32_MAX_LEVEL == 14
    assert [decoder_kernel.f32_tile(m) for m in range(1, 16)] == \
        [4] * 9 + [2, 2] + [1] * 4
    assert decoder_kernel.f32_tile_bytes(1 << 14, 1) <= \
        decoder_kernel.SCRATCH_SMEM_BYTES < \
        decoder_kernel.f32_tile_bytes(1 << 15, 1)
