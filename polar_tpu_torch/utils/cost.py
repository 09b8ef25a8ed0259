"""Static cost model of the decode and the card's work bounds.

The port of ``polar_tpu.utils.cost``:

* :func:`decode_cost` — the element-operation profile of a code's pruned
  Fast-SSC tree (which node kinds dominate), the same walk and weights as
  the JAX package's, so that both packages count the same work;
* the shared-memory facts of the card's decoder kernels, the counterparts
  of the TPU's VMEM footprint (``kernel_vmem_bytes``, ``max_frame_tile``):
  the scratch style's footprint and largest frame count a block, and the
  tile core's bytes a frame, from the values the kernels use
  (:mod:`polar_tpu_torch.ops.cuda.decoder_kernel`);
* the work model of each CUDA kernel — the bytes it must move and the
  operations it must do — and :func:`bound`, the least time an H100 could
  take for that work. ``chip_smoke.py`` reckons every ``bound_ms`` of its
  kernel table here.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..code.compiler import Node, compile_code
from ..code.construction import PolarCode
from ..ops.cuda import decoder_kernel, front_kernel

# Element-op multipliers per kind, the JAX package's (its sign-free
# kernel's). "f_cached" is an f whose input slot was produced by a parent
# f, whose min magnitudes the kernel hands down, so both abs ops vanish;
# the same for spc_cached (no abs, no guard).
_MULT = {
    "f": 7, "f_cached": 5, "g": 4, "comb": 1, "qadd": 3, "copy": 1,
    "sign": 2, "rate0": 1, "rate1": 2, "rep": 3, "spc": 8,
    "spc_cached": 6, "transform": 2,
}


@dataclass
class DecodeCost:
    n: int
    node_count: int
    elem_ops_per_frame: int   # weighted element ops
    by_kind: dict             # kind -> (elem_ops, sites)

    def summary(self) -> str:
        rows = sorted(self.by_kind.items(), key=lambda kv: -kv[1][0])
        lines = [f"Polar N={self.n}: {self.node_count} nodes, "
                 f"{self.elem_ops_per_frame:,} elem-ops/frame"]
        for kind, (ops, sites) in rows:
            pct = 100.0 * ops / max(1, self.elem_ops_per_frame)
            lines.append(f"  {kind:10s} {ops:10,d} ({pct:4.1f}%) over {sites} sites")
        return "\n".join(lines)


def decode_cost(code: PolarCode, tree: Node | None = None) -> DecodeCost:
    """Element-op profile of the pruned decode tree."""
    if tree is None:
        tree = compile_code(code)
    by_kind: dict = {}
    nodes = 0

    def add(kind, elems):
        ops, sites = by_kind.get(kind, (0, 0))
        by_kind[kind] = (ops + elems * _MULT[kind], sites + 1)

    def walk(n: Node, from_f: bool = False):
        nonlocal nodes
        nodes += 1
        length = 1 << n.level
        half = length // 2
        k = n.kind
        if k == "rate0":
            add("rate0", length)
        elif k == "rate1":
            add("rate1", length)
            add("transform", length * n.level // 2)
        elif k == "rep":
            add("rep", length)
        elif k == "spc":
            add("spc_cached" if from_f else "spc", length)
            add("transform", length * n.level // 2)
        elif k == "rate0_right":
            add("qadd", half)
            walk(n.right)
            add("copy", half)
        elif k == "rate1_comb":
            add("f_cached" if from_f else "f", half)
            walk(n.left, from_f=True)
            add("g", half)
            add("sign", half)
            add("transform", half * (n.level - 1) // 2)
            add("comb", half)
        elif k == "branch":
            add("f_cached" if from_f else "f", half)
            walk(n.left, from_f=True)
            add("g", half)
            walk(n.right)
            add("comb", half)

    walk(tree)
    total = sum(ops for ops, _ in by_kind.values())
    return DecodeCost(n=code.N, node_count=nodes,
                      elem_ops_per_frame=total, by_kind=by_kind)


# -- the card's shared memory (the TPU's VMEM facts) -----------------------

SMEM_BYTES = decoder_kernel.SCRATCH_SMEM_BYTES   # a block's shared memory


def scratch_smem_bytes(n: int, frames: int) -> int:
    """Shared memory of a scratch-style block holding ``frames`` frames
    (a multiple of 4) at code length ``n``: 2n bytes a frame."""
    return decoder_kernel.scratch_smem(n, frames // 4, 1)


def max_scratch_frames(n: int) -> int:
    """The most frames a scratch-style block holds at code length ``n``
    (:func:`~polar_tpu_torch.ops.cuda.decoder_kernel.scratch_frames`), or 0
    where one warp of frames does not fit (use the hybrid decoder)."""
    try:
        return decoder_kernel.scratch_frames(n)
    except ValueError:
        return 0


def tile_bytes_per_frame(n: int, want_cw: bool, root: bool = False) -> int:
    """Shared memory a frame of the tile core takes at code length ``n``
    (:func:`~polar_tpu_torch.ops.cuda.decoder_kernel.tile_bytes` over its
    frames a tile)."""
    return (decoder_kernel.tile_bytes(n, want_cw, root)
            // decoder_kernel.WHOLE_FRAMES)


# -- the work model and the bound ------------------------------------------
# The least time the card could take for a kernel's work ("bound_ms"): the
# larger of its bytes (each input read once, each output written once) over
# the H100 SXM's memory rate and its operations over the card's rate for
# them. None of these kernels uses the tensor cores, so every 32-bit
# integer or float operation is counted at the non-tensor float32 rate
# (NVIDIA's H100 SXM data sheet). Operation counts per element, the least
# each function must do:
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
PHILOX_OPS = 25   # a word: ten rounds of 2 mulhi, 2 mul, 4 xor, 2 adds per 4
NORMAL_OPS = 20   # a normal: half a Box-Muller pair (unit maps, log, sqrt,
                  # the sin/cos polynomial)
QUANT_OPS = 5     # an LLR: multiply, add, multiply, round, clamp
BITS_WORD_BYTES = 4   # a u32 word the bits-mode step reads


def transform_ops(n: int, stages: int | None = None) -> int:
    """Products of a polar transform's butterfly (or its first stages)."""
    return n // 2 * (n.bit_length() - 1 if stages is None else stages)


def decode_ops(n: int) -> int:
    """f and g element operations of SC over N rows; Fast-SSC does fewer."""
    return n * (n.bit_length() - 1)


def front_ops(n: int, k: int, draws: bool = True) -> int:
    """A systematic front: K message words and N noise words (``draws``;
    none where the words come in), N normals, N LLRs, two transforms."""
    return ((k + n) * PHILOX_OPS * draws + n * (NORMAL_OPS + QUANT_OPS)
            + 2 * transform_ops(n))


def decode_count_ops(n: int) -> int:
    """Decode, re-encode, and the five counters over N rows."""
    return decode_ops(n) + transform_ops(n) + 5 * n


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel's work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def front_work(name: str, n: int, k: int, b: int) -> tuple[int, int]:
    """(bytes, operations) of the block front's kernel A
    (``"front_blocks_a"``: K Philox words, the block's bottom stages, N
    bytes out a frame) or kernel B (``"front_blocks_b"``: N words, normals
    and LLRs, the bottom stages, y in and cw, LLR out) at Polar(n, k) and
    ``b`` frames, blocks as the front's."""
    level = n.bit_length() - 1
    if name == "front_blocks_a":
        stages = min(front_kernel.BLOCK_LEVEL, level)
        return n * b, (k * PHILOX_OPS + transform_ops(n, stages)) * b
    stages = min(front_kernel.CHAN_BLOCK_LEVEL, level)
    return 3 * n * b, (n * (PHILOX_OPS + NORMAL_OPS + QUANT_OPS)
                       + transform_ops(n, stages)) * b


def count_work(n: int, k: int, b: int) -> tuple[int, int]:
    """(bytes, operations) of the counter at Polar(n, k) and ``b`` frames:
    llr and cw at every row, hat at the K info rows (the kernel never reads
    it at a frozen row); five compares an element."""
    return (2 * n + k) * b, 5 * n * b


def count_frames_work(n: int, k: int, b: int) -> tuple[int, int]:
    """(bytes, operations) of the draws path's u-domain counter at
    Polar(n, k) and ``b`` frames: frame-major message and decoded (K a
    frame) and codeword and LLRs (N a frame) read once; two compares an
    LLR (its sign against the codeword's, zero) and three an estimate
    (zero, its sign against the message's, the frame's any)."""
    return 2 * (n + k) * b, (2 * n + 3 * k) * b


def step_work(n: int, k: int, b: int, bits: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the fused step at Polar(n, k) and ``b``
    frames: it moves nothing but its five counters when it draws its own
    words; in bits mode it reads the (2N, B) u32 words (8 bytes an element)
    and draws none."""
    return (2 * n * BITS_WORD_BYTES * b * bits,
            (front_ops(n, k, draws=not bits) + decode_count_ops(n)) * b)


def row_work(name: str, *, n: int, b: int, k: int | None = None,
             mesg_bits: int | None = None, level: int | None = None,
             shards: int | None = None, bits: bool = False) -> tuple[int, int]:
    """(bytes, operations) of a row of the kernel table at its shape:
    ``n`` rows (the code's N, a subtree node's length, or a ring position's
    rows), ``b`` frames, ``k`` message rows, ``mesg_bits`` a node's message
    bits, ``level`` the code's level (the middle stages), ``shards`` the
    ring's positions, ``bits`` the bits mode (step, symbols)."""
    if name in ("fastssc_decoder_u", "scratch_decoder", "interp_decoder"):
        return (n + k) * b, decode_ops(n) * b
    if name == "f32_decoder":           # float32 LLRs in, int8 u out
        return (4 * n + k) * b, decode_ops(n) * b
    if name == "fastssc_decoder_cw":
        return (2 * n + k) * b, (decode_ops(n) + transform_ops(n)) * b
    if name == "mc_step":
        return step_work(n, k, b, bits)
    if name == "subtree_decoder":        # the slot in, hard and cw out
        return 3 * n * b, (decode_ops(n) + transform_ops(n)) * b
    if name in ("front_blocks_a", "front_blocks_b"):
        return front_work(name, n, k, b)
    if name == "count":
        return count_work(n, k, b)
    if name == "count_frames":
        return count_frames_work(n, k, b)
    if name == "channel_symbols":        # bits: int64 words in, bytes out
        return (9 * k * b, 0) if bits else (k * b, k * b * PHILOX_OPS)
    if name == "channel_awgn":
        return 2 * n * b, n * b * (2 * PHILOX_OPS + 2 * NORMAL_OPS + QUANT_OPS)
    if name == "block_encoder":
        return (k + n) * b, 2 * transform_ops(n) * b
    if name == "front_whole":
        return 2 * n * b, front_ops(n, k) * b
    if name in ("decode_count", "interp_decode_count"):
        return 2 * n * b, decode_count_ops(n) * b
    if name == "front_middle":
        return 2 * n * b, (level - front_kernel.BLOCK_LEVEL) * n * b
    if name == "scratch_subtree":
        return (2 * n + mesg_bits) * b, decode_ops(n) * b
    if name == "interp_subtree":
        return 3 * n * b, (decode_ops(n) + transform_ops(n)) * b
    if name == "ring_shift":
        return 2 * shards * n * b, 0
    raise ValueError(f"no work model for kernel {name!r}")
