"""The port's cost model (``polar_tpu_torch.utils.cost``): the decode's
element-op profile against the JAX package's, the card's shared-memory
facts against the decoder kernels' own values, and the work model behind
``chip_smoke.py``'s ``bound_ms``, pinned to the bounds of the kernel table
that an H100 run printed before the model moved out of the smoke."""

from pathlib import Path

import numpy as np
import pytest

from polar_tpu.code.construction import PolarCode as JPolarCode
from polar_tpu.code.construction import make_code as j_make_code
from polar_tpu.utils.cost import decode_cost as j_decode_cost
import polar_tpu_torch as pt
from polar_tpu_torch.ops.cuda import decoder_kernel, front_kernel
from polar_tpu_torch.utils import cost

with np.load(Path(__file__).resolve().parent / "vectors" / "golden.npz") as _z:
    GOLDEN = {k: _z[k] for k in sorted(_z.files) if k.startswith("mask_")}


def _same_cost(mask, level):
    got = cost.decode_cost(pt.PolarCode(level, mask))
    want = j_decode_cost(JPolarCode(level, mask))
    assert (got.n, got.node_count, got.elem_ops_per_frame, got.by_kind) == (
        want.n, want.node_count, want.elem_ops_per_frame, want.by_kind)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_decode_cost_equals_jax_on_golden_codes(key):
    _same_cost(GOLDEN[key], int(key.split("_")[1]))


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
def test_decode_cost_equals_jax_at_every_level(rate):
    for m in range(2, 15):
        _same_cost(j_make_code(m, rate=rate).frozen, m)


def test_shared_memory_facts_are_the_kernels():
    dk = decoder_kernel
    assert cost.SMEM_BYTES == dk.SCRATCH_SMEM_BYTES
    for m in range(1, 16):
        n = 1 << m
        if m <= dk.SCRATCH_MAX_LEVEL:
            frames = dk.scratch_frames(n)
            assert cost.max_scratch_frames(n) == frames
            assert cost.scratch_smem_bytes(n, frames) == 2 * n * frames
            assert cost.scratch_smem_bytes(n, frames) <= cost.SMEM_BYTES
            for level_batch in (1, 4096, 32768):
                wr, _, warps = dk.scratch_shape(m, level_batch)
                assert cost.scratch_smem_bytes(n, 4 * wr * warps) == \
                    dk.scratch_smem(n, wr, warps)
        else:
            assert cost.max_scratch_frames(n) == 0
        for want_cw in (False, True):
            for root in (False, True):
                assert (cost.tile_bytes_per_frame(n, want_cw, root)
                        * dk.WHOLE_FRAMES == dk.tile_bytes(n, want_cw, root))
                assert cost.tile_bytes_per_frame(n, want_cw, root) == \
                    (2 + want_cw + root) * n


# (row, shape of row_work, bound_ms, bound_by): the kernels line of an
# H100 run of chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W) before the
# work model moved here, every row's main shape and each by_shape entry
PINNED = [
    ("fastssc_decoder_u", dict(n=1024, k=512, b=32768),
     0.015024372537313433, "bytes"),
    ("fastssc_decoder_cw", dict(n=1024, k=512, b=32768),
     0.02504062089552239, "bytes"),
    ("mc_step", dict(n=1024, k=512, b=32768),
     0.04632514865671642, "operations"),
    ("subtree_decoder", dict(n=512, b=16384), 0.007512186268656716, "bytes"),
    ("front_blocks_a", dict(n=131072, k=65536, b=4096),
     0.16025997373134326, "bytes"),
    ("front_blocks_a", dict(n=131072, k=65536, b=16384),
     0.641039894925373, "bytes"),
    ("front_blocks_a", dict(n=4096, k=2048, b=4096),
     0.005008124179104477, "bytes"),
    ("front_blocks_b", dict(n=131072, k=65536, b=4096),
     0.48077992119402985, "bytes"),
    ("front_blocks_b", dict(n=16384, k=8192, b=4096),
     0.06009749014925373, "bytes"),
    ("count", dict(n=131072, k=65536, b=4096), 0.4006499343283582, "bytes"),
    ("count", dict(n=8192, k=4096, b=4096), 0.02504062089552239, "bytes"),
    ("count_frames", dict(n=16384, k=8192, b=4096), 0.06009749014925373,
     "bytes"),
    ("count_frames", dict(n=1024, k=512, b=32768), 0.030048745074626865,
     "bytes"),
    ("channel_symbols", dict(n=1024, k=512, b=32768),
     0.006260155223880597, "operations"),
    ("channel_symbols", dict(n=131072, k=65536, b=4096),
     0.10016248358208955, "operations"),
    ("channel_awgn", dict(n=1024, k=512, b=32768),
     0.04757717970149254, "operations"),
    ("channel_awgn", dict(n=131072, k=65536, b=4096),
     0.7612348752238807, "operations"),
    ("block_encoder", dict(n=1024, k=512, b=32768),
     0.015024372537313433, "bytes"),
    ("block_encoder", dict(n=131072, k=65536, b=4096),
     0.24038996059701492, "bytes"),
    ("front_whole", dict(n=256, k=128, b=32768),
     0.008826818865671642, "operations"),
    ("front_whole", dict(n=4096, k=2048, b=4096),
     0.01865526256716418, "operations"),
    ("decode_count", dict(n=256, k=128, b=32768),
     0.005008124179104477, "bytes"),
    ("decode_count", dict(n=1024, k=512, b=32768),
     0.020032496716417908, "bytes"),
    ("front_middle", dict(n=4096, b=4096, level=12),
     0.010016248358208954, "bytes"),
    ("scratch_decoder", dict(n=1024, k=512, b=32768),
     0.015024372537313433, "bytes"),
    ("scratch_decoder", dict(n=64, k=32, b=4096),
     0.00011737791044776119, "bytes"),
    ("scratch_subtree", dict(n=512, b=4096, mesg_bits=509),
     0.0018743785074626866, "bytes"),
    ("scratch_subtree", dict(n=512, b=16384, mesg_bits=509),
     0.007497514029850746, "bytes"),
    ("interp_decoder", dict(n=1024, k=512, b=32768),
     0.015024372537313433, "bytes"),
    ("interp_decode_count", dict(n=131072, b=4096),
     0.3205199474626865, "bytes"),
    ("interp_subtree", dict(n=512, b=4096), 0.001878046567164179, "bytes"),
    ("ring_shift", dict(n=16384, b=4096, shards=8),
     0.3205199474626865, "bytes"),
]


@pytest.mark.parametrize("name,shape,ms,by", PINNED,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(PINNED)])
def test_bounds_are_the_kernel_tables(name, shape, ms, by):
    got_ms, got_by = cost.bound(*cost.row_work(name, **shape))
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-15)


def test_row_one_bound_and_the_bits_step():
    assert round(cost.bound(*cost.row_work(
        "fastssc_decoder_u", n=1024, k=512, b=32768))[0], 6) == 0.015024
    n, k, b = 1024, 512, 32768
    native = cost.row_work("mc_step", n=n, k=k, b=b)
    bits = cost.row_work("mc_step", n=n, k=k, b=b, bits=True)
    # the (2N, B) u32 words in: 8 bytes an element; no Philox word drawn
    assert bits[0] - native[0] == 8 * n * b
    assert native[1] - bits[1] == (n + k) * cost.PHILOX_OPS * b
    # reading them takes longer than the work: bound by bytes, where the
    # native step is bound by operations
    assert cost.bound(*bits)[1] == "bytes"
    assert cost.bound(*native)[1] == "operations"
    # the front's block level is the kernels'
    assert cost.front_work("front_blocks_a", 1 << 12, 1 << 11, 1)[1] == (
        (1 << 11) * cost.PHILOX_OPS
        + cost.transform_ops(1 << 12, front_kernel.BLOCK_LEVEL))
    with pytest.raises(ValueError, match="no work model"):
        cost.row_work("no_such_kernel", n=4, b=1)
