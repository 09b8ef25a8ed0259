"""The tile core's register block on the host: its size, its stage counts
and a model of its lanes.

``csrc/fastssc_simd.cuh`` runs the polar transforms of a node (rate-1,
SPC, RATE1_COMB, the interpreter's grate1, the cw track's second
transform, the tile step's encode) and REP's folds in a register block: a
lane of a tile of WR words a row, VW of them a lane, keeps its rows of up
to :func:`reg_passes` passes in registers, so a block covers
:func:`block_rows` rows. Stage ``s`` pairs rows ``i`` and ``i + 2^s``:
below a pass (``kPass`` = 32 VW / WR rows) the partner is the lane
``(WR / VW) << s`` away (``__shfl_xor_sync``), from a pass up one of the
lane's own registers; the stages of a node larger than the block from the
block's size up run in shared memory, one pass and one ``__syncwarp``
each. REP folds rows ``i`` and ``i + h`` in halves, in that order: in
registers while ``h`` is at most the block (``__shfl_down_sync`` below a
pass), in shared memory above; the frame-major instances (``FRAMES``)
keep every fold in shared memory.

:func:`program_stages` counts, for a byte program (``emit_program``) and a
tile shape, the stages the tile runs in registers and those it runs in
shared memory: the counter that the decoders' plans, the interpreter's
``info()`` and ``chip_smoke.py`` report. :func:`lane_transform` and
:func:`lane_fold` model the lanes, passes, partners and block edge in
torch, for the CPU tests to hold against ``polar_transform`` and REP's
fold. :func:`device_block_rows` reads the card's instances' block, which
the card tests hold equal to :func:`block_rows`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

# csrc/fastssc_simd.cuh kRegWords: the words of a node's rows a lane keeps
REG_WORDS = 2
# the tile shapes the kernels build: (wr, vw, float32)
SHAPES = ((2, 2, False), (4, 1, False), (8, 1, False), (32, 1, False),
          (1, 1, True), (2, 2, True), (4, 4, True))
# csrc/fastssc.cuh opcodes
(OP_LEFT, OP_RIGHT, OP_COMB, OP_RATE0, OP_RATE1, OP_REP, OP_SPC,
 OP_RATE0_RIGHT, OP_RATE0_COMB, OP_RATE1_COMB) = range(10)
OP_END = 255


def reg_passes(vw: int) -> int:
    """Passes of a node's rows a lane holding ``vw`` words of a row keeps in
    registers (``fastssc_simd.cuh`` reg_passes)."""
    return max(1, REG_WORDS // vw)


def block_rows(wr: int, vw: int) -> int:
    """Rows of a node the register block of shape (wr, vw) covers."""
    return reg_passes(vw) * (32 * vw // wr)


def _log2(n: int) -> int:
    return n.bit_length() - 1


def transform_stages(length: int, block: int) -> tuple[int, int]:
    """(register, shared-memory) stages of a transform of ``length`` rows
    with a register block of ``block`` rows."""
    total = _log2(length)
    reg = min(total, _log2(block)) if block else 0
    return reg, total - reg


def fold_stages(length: int, block: int) -> tuple[int, int]:
    """(register, shared-memory) folds of REP over ``length`` rows: a fold
    into ``h`` rows runs in registers where ``h`` is at most ``block``."""
    total = _log2(length)
    reg = min(total, _log2(block) + 1) if block else 0
    return reg, total - reg


def program_stages(program, block: int, cw: bool,
                   folds: bool = True) -> dict:
    """The transform and fold stages one tile runs for a byte program
    (``[level, opcodes..., 255]``) with a register block of ``block`` rows
    (0: none), on the cw track (``cw``: every rate-1, SPC and RATE1_COMB
    transforms twice) or not, REP's folds in the block (``folds``; the
    frame-major instances: not): ``{"reg_stages", "smem_stages"}``."""
    prog = np.asarray(program, np.uint8)
    lvl = int(prog[0])
    reg = smem = 0
    for op in prog[1:]:
        op = int(op)
        if op == OP_END:
            break
        length = 1 << lvl
        if op in (OP_RATE1, OP_SPC, OP_RATE1_COMB):
            r, s = transform_stages(length, block)
            reg, smem = reg + r * (1 + cw), smem + s * (1 + cw)
        elif op == OP_REP:
            r, s = fold_stages(length, block if folds else 0)
            reg, smem = reg + r, smem + s
        if op in (OP_LEFT, OP_RATE0_RIGHT):
            lvl -= 1
        elif op in (OP_COMB, OP_RATE0_COMB, OP_RATE1_COMB):
            lvl += 1
    return {"reg_stages": reg, "smem_stages": smem}


def add_stages(*counts: dict) -> dict:
    """The sum of stage counts."""
    return {k: sum(c[k] for c in counts) for k in ("reg_stages",
                                                    "smem_stages")}


def step_stages(program, n: int, systematic: bool, block: int) -> dict:
    """The tile step's stages: the encode's transforms of ``n`` rows (a
    second after the refreeze where ``systematic``) and the cw track's
    decode of ``program``."""
    r, s = transform_stages(n, block)
    enc = 1 + systematic
    return add_stages({"reg_stages": r * enc, "smem_stages": s * enc},
                      program_stages(program, block, True))


def device_block_rows(device) -> dict:
    """``{(wr, vw, f32): rows}`` of the card's instances
    (``polar_tile_block_rows``); a CUDA device only."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the block of the card's instances is read on a "
                         f"CUDA device, not {device}")
    lib = build.load_library()
    return {s: int(lib.polar_tile_block_rows(*map(int, s))) for s in SHAPES}


# -- the lane model -----------------------------------------------------------

def _geometry(wr: int, vw: int):
    lanes_row = wr // vw
    kpass = 32 // lanes_row
    passes = reg_passes(vw)
    return lanes_row, kpass, passes, passes * kpass


def _to_lanes(rows, lanes_row: int, kpass: int, passes: int, fill):
    """(rows, lanes_row, w) to (32, passes, w): lane ``r0 * lanes_row + c``
    holds column group c of row ``r0 + p kpass`` at pass p, ``fill`` past
    the rows."""
    regs = torch.full((32, passes) + tuple(rows.shape[2:]), fill,
                      dtype=rows.dtype)
    for lane in range(32):
        r0, c = divmod(lane, lanes_row)
        for p in range(passes):
            if r0 + p * kpass < rows.shape[0]:
                regs[lane, p] = rows[r0 + p * kpass, c]
    return regs


def _from_lanes(regs, length: int, lanes_row: int, kpass: int):
    out = torch.empty((length, lanes_row) + tuple(regs.shape[2:]),
                      dtype=regs.dtype)
    for lane in range(32):
        r0, c = divmod(lane, lanes_row)
        for p in range(regs.shape[1]):
            if r0 + p * kpass < length:
                out[r0 + p * kpass, c] = regs[lane, p]
    return out


def _reg_transform(regs, passes: int, length: int, lanes_row: int,
                   kpass: int) -> None:
    """fastssc_simd.cuh reg_transform on the model's lanes, in place."""
    lane = torch.arange(32)
    lim = kpass if passes > 1 else length
    s = 0
    while (1 << s) < kpass and (1 << s) < lim:
        partner = regs[lane ^ (lanes_row << s)]
        lower = ((lane // lanes_row) & (1 << s)) == 0
        lower = lower.view(32, *([1] * (regs.dim() - 1)))
        regs.copy_(torch.where(lower, regs * partner, regs))
        s += 1
    d = 1
    while d < passes:
        for p in range(passes):
            if not p & d:
                regs[:, p] = regs[:, p] * regs[:, p + d]
        d *= 2


def lane_transform(rows, wr: int, vw: int):
    """The tile's polar transform of ``rows`` ((len, F) hard values, F a
    multiple of wr / vw) as the lanes of shape (wr, vw) run it: the
    register block's shuffles and passes, then the shared-memory stages
    from the block up."""
    lanes_row, kpass, passes, block = _geometry(wr, vw)
    n = rows.shape[0]
    x = rows.reshape(n, lanes_row, -1).clone()
    if n <= block:
        np_ = max(1, n // kpass)
        regs = _to_lanes(x, lanes_row, kpass, np_, 1)
        _reg_transform(regs, np_, n, lanes_row, kpass)
        return _from_lanes(regs, n, lanes_row, kpass).reshape(n, -1)
    for c in range(0, n, block):
        regs = _to_lanes(x[c:c + block], lanes_row, kpass, passes, 1)
        _reg_transform(regs, passes, block, lanes_row, kpass)
        x[c:c + block] = _from_lanes(regs, block, lanes_row, kpass)
    for s in range(_log2(block), _log2(n)):
        h = 1 << s
        v = x.reshape(n // (2 * h), 2, h, *x.shape[1:])
        v[:, 0] = v[:, 0] * v[:, 1]
    return x.reshape(n, -1)


def lane_fold(rows, wr: int, vw: int, add):
    """REP's fold of ``rows`` ((len, F), len >= 2) as the lanes of shape
    (wr, vw) run it with the elementwise ``add`` where its folds are in the
    register block: row 0's sum, as every lane of its column group holds
    it after the broadcast, (F,)."""
    lanes_row, kpass, passes, block = _geometry(wr, vw)
    n = rows.shape[0]
    x = rows.reshape(n, lanes_row, -1)
    h = n // 2
    if h <= block:
        np_ = max(1, h // kpass)
        regs = _to_lanes(add(x[:h], x[h:]), lanes_row, kpass, np_, 0)
    else:
        soft = add(x[:h], x[h:])
        while h > 2 * block:
            h //= 2
            soft = add(soft[:h], soft[h:2 * h])
        h //= 2
        np_ = passes
        regs = _to_lanes(add(soft[:h], soft[h:2 * h]), lanes_row, kpass,
                         np_, 0)
    d = np_ // 2
    while d >= 1:
        for p in range(d):
            regs[:, p] = add(regs[:, p], regs[:, p + d])
        d //= 2
    lim = kpass if np_ > 1 else h
    lane = torch.arange(32)
    s = kpass // 2
    while s >= 1:
        if s < lim:   # __shfl_down_sync: a lane past the warp keeps its own
            src = lane + s * lanes_row
            src = torch.where(src < 32, src, lane)
            regs[:, 0] = add(regs[:, 0], regs[src, 0])
        s //= 2
    got = regs[lane % lanes_row, 0]                    # the broadcast
    row0 = got[:lanes_row]
    if not all(torch.equal(got[i], row0[i % lanes_row]) for i in range(32)):
        raise AssertionError("the broadcast left lanes apart")
    return row0.reshape(-1)
