"""kernels_roofline.decode: the least time of the decodes the traced window
completed, as a share of the card's busy time in it (%).

The work model is the least a decode must do, counted from the code's
shape and the frames done: N LLR bytes read and K u bytes written a frame,
and SC's f and g operations over N rows (Fast-SSC does fewer). (A frozen
copy of the decoder rows' work in ``polar_tpu_torch/utils/cost.py`` as the
benchmark was defined.)
"""

from peaks import least_seconds


def decode_work(n: int, k: int, frames: int) -> tuple[int, int]:
    """(bytes, operations) of decoding ``frames`` frames of Polar(n, k)."""
    return (n + k) * frames, n * (n.bit_length() - 1) * frames


def read(run):
    trace = run["trace"]
    if not trace or trace["busy_s"] <= 0 or not run["frames"]:
        return None
    least, _ = least_seconds(*decode_work(run["n"], run["k"], run["frames"]))
    return 100.0 * least / trace["busy_s"]
