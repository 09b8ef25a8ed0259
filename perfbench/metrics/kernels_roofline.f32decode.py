"""kernels_roofline.f32decode: the float32 decode kernel against its bound
in the traced window (%): the least time of the decodes the window
completed, over the device time launched inside the program's span
``kernel.f32_decoder_frames``. A program without that span gives nothing.

The work model is the least such a decode must do, counted from the code's
Fast-SSC tree (``reference.polar.tree``) and the frames done: per frame
the N float32 LLRs (4 bytes each) read and the K u bytes written once; one
operation an output row of every f, g and rate-0-left sum, and one a row
of every leaf (rate-1's signs, repetition's fold and sign, SPC's
decisions). The larger of the bytes at the memory rate and the operations
at the float32 rate bounds it. (A frozen copy, as this metric was
defined.)"""

import numpy as np

from peaks import least_seconds
from program_trace import of
from reference import polar

SPAN = "kernel.f32_decoder_frames"


def tree_ops(node) -> int:
    """f, g and leaf operations of one frame through a node of
    ``reference.polar.tree``."""
    kind, level, left, right = node
    n = 1 << level
    if kind == "rate0":
        return 0
    if kind in ("rate1", "rep", "spc"):
        return n
    if kind == "rate0_left":
        return n // 2 + tree_ops(right)
    if kind == "rate1_right":
        return n // 2 + tree_ops(left) + n // 2 + n // 2
    return n // 2 + tree_ops(left) + n // 2 + tree_ops(right)


def decode_work(frozen, frames: int) -> tuple[int, int]:
    """(bytes, operations) of decoding ``frames`` frames of float32 LLRs
    of the code of the frozen mask ``frozen``."""
    frozen = np.asarray(frozen, dtype=np.uint8)
    n = frozen.size
    k = int((frozen == 0).sum())
    return (4 * n + k) * frames, tree_ops(polar.tree(frozen)) * frames


def read(run):
    program = of(run)
    if program is None or not run["frames"] or "frozen" not in run:
        return None
    seconds = program["device_by_span"].get(SPAN)
    if not seconds:
        return None
    least, _ = least_seconds(*decode_work(run["frozen"], run["frames"]))
    return 100.0 * least / seconds
