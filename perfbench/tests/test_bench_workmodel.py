"""The frozen work model of the roofline readers equals the program's
(``polar_tpu_torch/utils/cost.py``) at both configurations, as of the
commit that defined the benchmark."""

import pytest

import harness
import peaks
from polar_tpu_torch.utils import cost

SHAPES = [(16384, 8192, 4096), (1024, 512, 32768), (16384, 8192, 2048)]


def _model(name):
    return harness.Bench({}).reader(name)


@pytest.mark.parametrize("n,k,b", SHAPES)
def test_step_work(n, k, b):
    assert _model("kernels_roofline.campaign").step_work(n, k, b) == \
        cost.step_work(n, k, b)


@pytest.mark.parametrize("n,k,b", SHAPES)
@pytest.mark.parametrize("row", ["scratch_decoder", "interp_decoder"])
def test_decode_work(n, k, b, row):
    assert _model("kernels_roofline.decode").decode_work(n, k, b) == \
        cost.row_work(row, n=n, k=k, b=b)


def test_peaks():
    assert (peaks.HBM_BYTES_PER_S, peaks.OPS_PER_S) == (
        cost.HBM_BYTES_PER_S, cost.OPS_PER_S)
    for nbytes, ops in [(0, 6.88e9), (5.03e7, 3.36e8)]:
        t, by = peaks.least_seconds(nbytes, ops)
        ms, by_ms = cost.bound(nbytes, ops)
        assert by == by_ms and t * 1e3 == pytest.approx(ms)
