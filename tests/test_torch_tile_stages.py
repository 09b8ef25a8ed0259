"""The tile core's register block on the CPU: a model of its lanes, passes,
shuffle partners and block edge against ``polar_transform`` and REP's fold,
and the stage counts the plans report (``ops/cuda/tile_stages.py``)."""

import numpy as np
import pytest
import torch

import polar_tpu_torch as pt
from polar_tpu_torch.ops import arith
from polar_tpu_torch.ops.cuda import decoder_kernel, tile_stages
from polar_tpu_torch.ops.transform import polar_transform

# every shape of SCRATCH_TABLE (the (2, 2) tile core among them), and the
# float kernel's
SHAPES = sorted({(wr, vw, False) for row in decoder_kernel.SCRATCH_TABLE
                 .values() for wr, vw, _ in row} | {(2, 2, False)}
                | {(w, w, True) for w in (1, 2, 4)})
LENGTHS = [1 << s for s in range(11)]


def _fold_reference(x, add):
    """REP's fold (decode/fastssc.py _rep): in halves, row 0's sum."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = add(x[:h], x[h:])
    return x[0]


def test_the_cases_cover_the_block_edge():
    """Each shape's block (and twice it) is among the lengths."""
    for wr, vw, f32 in SHAPES:
        b = tile_stages.block_rows(wr, vw)
        assert b in LENGTHS and 2 * b in LENGTHS, (wr, vw, f32, b)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    map(str, s[:2])) + ("f32" if s[2] else ""))
@pytest.mark.parametrize("length", LENGTHS)
def test_register_block_matches_transform_and_fold(shape, length):
    """The lanes' stage schedule equals polar_transform on {-1, 0, +1}
    rows and REP's saturating (float: plain) fold on full-range rows."""
    wr, vw, f32 = shape
    g = torch.Generator().manual_seed(length * 131 + wr * 7 + vw)
    cols = 4 * (wr // vw)
    hard = torch.randint(-1, 2, (length, cols), generator=g,
                         dtype=torch.int8)
    if length >= 4:
        hard[: length // 4] = 1       # runs of +1 and of 0, as a node holds
        hard[length // 4: length // 2, 0] = 0
    dtype = torch.float32 if f32 else torch.int8
    got = tile_stages.lane_transform(hard.to(dtype), wr, vw)
    assert torch.equal(got, polar_transform(hard, axis=0).to(dtype))
    if length == 1:
        return
    if f32:
        soft = torch.randn((length, cols), generator=g) * 50
        soft[0] = -0.0
        add = torch.add
    else:
        soft = torch.randint(-128, 128, (length, cols), generator=g,
                             dtype=torch.int8)
        soft[:, 0] = 127          # saturates: the pairing order shows
        soft[::2, 1] = -128
        add = arith.Int8Arith().qadd
    got = tile_stages.lane_fold(soft, wr, vw, add)
    want = _fold_reference(soft, add)
    assert torch.equal(got, want)
    if f32:
        assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_stage_counts_add_up_to_the_programs_stages():
    """Register and shared-memory stages sum to every transform's and
    fold's stages; no block leaves them all in shared memory; a larger
    block moves stages into registers."""
    code = pt.make_code(10, rate=0.5)
    prog = pt.compile_program(code)
    none = tile_stages.program_stages(prog, 0, cw=False)
    assert none["reg_stages"] == 0
    total = none["smem_stages"]
    last = -1
    for block in (1, 8, 32, 128, 1024):
        c = tile_stages.program_stages(prog, block, cw=False)
        assert c["reg_stages"] + c["smem_stages"] == total
        assert c["reg_stages"] >= last
        last = c["reg_stages"]
    assert last == total
    cw = tile_stages.program_stages(prog, 128, cw=True)
    u = tile_stages.program_stages(prog, 128, cw=False)
    assert cw["reg_stages"] > u["reg_stages"]


def test_stage_counts_by_node():
    """A transform of 2^t rows has t stages, REP over 2^t rows t folds:
    the block's share in registers."""
    assert tile_stages.transform_stages(1024, 128) == (7, 3)
    assert tile_stages.transform_stages(64, 128) == (6, 0)
    assert tile_stages.transform_stages(256, 0) == (0, 8)
    assert tile_stages.fold_stages(1024, 128) == (8, 2)
    assert tile_stages.fold_stages(256, 128) == (8, 0)
    assert tile_stages.fold_stages(512, 128) == (8, 1)
    assert tile_stages.fold_stages(4, 0) == (0, 2)
    prog = np.array([3, tile_stages.OP_SPC, tile_stages.OP_END], np.uint8)
    assert tile_stages.program_stages(prog, 4, cw=True) == {
        "reg_stages": 4, "smem_stages": 2}
    rep = np.array([4, tile_stages.OP_REP, tile_stages.OP_END], np.uint8)
    assert tile_stages.program_stages(rep, 4, cw=True) == {
        "reg_stages": 3, "smem_stages": 1}
    assert tile_stages.program_stages(rep, 4, cw=False, folds=False) == {
        "reg_stages": 0, "smem_stages": 4}


def test_plans_count_the_frame_major_folds_in_shared_memory():
    """The frame-major u track's plan leaves REP's folds in shared memory,
    the element-major cw track's runs them in the block; the interpreter's
    u decoder plans its frame-major instance."""
    from polar_tpu_torch.ops.cuda import interp_kernel

    code = pt.make_code(10, rate=0.5)
    prog = pt.compile_program(code)
    frames = decoder_kernel.plan(prog, 32768, "scratch")
    lanes = decoder_kernel.plan(prog, 32768, "scratch", layout="lanes")
    assert frames["block_rows"] == lanes["block_rows"] == 32
    assert frames["smem_stages"] > lanes["smem_stages"]
    assert (frames["reg_stages"] + frames["smem_stages"]
            == lanes["reg_stages"] + lanes["smem_stages"])
    f32 = decoder_kernel.plan(prog, 32768, f32=True)
    assert f32["kernel"] == "f32" and f32["smem_stages"] > 0
    c = interp_kernel._compile(pt.compile_code(code), code.frozen, 10,
                               False, True)
    assert c.tile_stages(frames=True) == {
        "reg_stages": frames["reg_stages"],
        "smem_stages": frames["smem_stages"]}
    assert c.info()["reg_stages"] == lanes["reg_stages"]


def test_device_block_rows_needs_a_card():
    with pytest.raises(ValueError):
        tile_stages.device_block_rows("cpu")
