"""kernels_roofline.campaign: the least time of the Monte-Carlo steps the
traced window completed, as a share of the card's busy time in it (%).

The work model is the least a step must do, counted from the code's shape
and the frames done, whatever kernels do it: per frame K message and N
noise Philox words, N normals and quantized LLRs, the systematic encode's
two transforms, the decode's f and g operations over N rows, the
re-encode's transform and five compares a row; nothing moved to or from
memory but the five counters. (A frozen copy of the step's work in
``polar_tpu_torch/utils/cost.py`` as the benchmark was defined.)
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
    """(bytes, operations) of ``frames`` frames of a step at Polar(n, k)."""
    front = (k + n) * PHILOX_OPS + n * (NORMAL_OPS + QUANT_OPS) \
        + 2 * transform_ops(n)
    back = decode_ops(n) + transform_ops(n) + 5 * n
    return 0, (front + back) * frames


def read(run):
    trace = run["trace"]
    if not trace or trace["busy_s"] <= 0 or not run["frames"]:
        return None
    least, _ = least_seconds(*step_work(run["n"], run["k"], run["frames"]))
    return 100.0 * least / trace["busy_s"]
