"""kernels_roofline.nonsys: the least time of the non-systematic
Monte-Carlo steps the traced window completed, as a share of the card's
busy time in it (%).

The work model is the least such a step must do, counted from the code's
shape and the frames done, whatever kernels do it: per frame K message
and N noise Philox words (a Box-Muller pair gives two normals), N normals
and quantized LLRs, the encode's one transform, the decode's f and g
operations over N rows and five compares a row; nothing moved to or from
memory but the five counters. (A frozen copy, as this metric was defined;
the systematic step's is ``kernels_roofline.campaign``'s.)
"""

from peaks import least_seconds

PHILOX_OPS = 25   # a word: ten rounds of 2 mulhi, 2 mul, 4 xor, 2 adds per 4
NORMAL_OPS = 20   # a normal: half a Box-Muller pair
QUANT_OPS = 5     # an LLR: multiply, add, multiply, round, clamp


def transform_ops(n: int) -> int:
    return n // 2 * (n.bit_length() - 1)


def decode_ops(n: int) -> int:
    return n * (n.bit_length() - 1)


def step_work(n: int, k: int, frames: int) -> tuple[int, int]:
    """(bytes, operations) of ``frames`` non-systematic frames of a step at
    Polar(n, k)."""
    front = (k + n) * PHILOX_OPS + n * (NORMAL_OPS + QUANT_OPS) \
        + transform_ops(n)
    back = decode_ops(n) + 5 * n
    return 0, (front + back) * frames


def read(run):
    trace = run["trace"]
    if not trace or trace["busy_s"] <= 0 or not run["frames"]:
        return None
    least, _ = least_seconds(*step_work(run["n"], run["k"], run["frames"]))
    return 100.0 * least / trace["busy_s"]
