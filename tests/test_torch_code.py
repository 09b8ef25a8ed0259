"""polar_tpu_torch's numpy code layer against polar_tpu's.

The port carries its own copy of code construction and the Fast-SSC
compiler (importing polar_tpu would import JAX); these tests hold the copy
equal to the original mask for mask and byte for byte, and to the
reference-made golden vectors.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import polar_tpu as jpt
import polar_tpu_torch as pt

VEC = Path(__file__).resolve().parent / "vectors" / "golden.npz"
CASES = [(m, r) for m in range(2, 15) for r in (0.25, 0.5, 0.75)]


@pytest.fixture(scope="module")
def vectors():
    with np.load(VEC) as z:
        return dict(z.items())


@pytest.mark.parametrize("m,rate", CASES)
def test_masks_and_programs_match_jax(m, rate):
    jc = jpt.make_code(m, rate=rate)
    c = pt.make_code(m, rate=rate)
    np.testing.assert_array_equal(c.frozen, np.asarray(jc.frozen))
    assert (c.N, c.K) == (jc.N, jc.K)
    np.testing.assert_array_equal(pt.compile_program(c),
                                  np.asarray(jpt.compile_program(jc)))


@pytest.mark.parametrize("level", [3, 9, 14])
def test_bhattacharyya_and_threshold_match_jax(level):
    a = pt.bhattacharyya_dual(level)
    b = jpt.bhattacharyya_dual(level)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(pt.frozen_mask_threshold(level, 0.3, 0.2),
                                  jpt.frozen_mask_threshold(level, 0.3, 0.2))


def test_golden_masks_and_programs(vectors):
    n = 0
    for key, mask in vectors.items():
        if key.startswith("mask_"):
            _, m, rk = key.split("_")
            code = pt.make_code(int(m), K=int(int(rk) / 100 * (1 << int(m))))
            np.testing.assert_array_equal(code.frozen, mask, err_msg=key)
            np.testing.assert_array_equal(pt.compile_program(code),
                                          vectors[f"prog_{m}_{rk}"], err_msg=key)
            n += 1
        elif key.startswith("maskth_"):
            _, m, pe, th = key.split("_")
            np.testing.assert_array_equal(
                pt.frozen_mask_threshold(int(m), float(pe), float(th)), mask,
                err_msg=key)
    assert n >= 20


@pytest.mark.parametrize("m", [2, 7, 12])
def test_code_from_jax_round_trips(m):
    jc = jpt.make_code(m, rate=0.5)
    c = pt.code_from_jax(jc)
    assert isinstance(c, pt.PolarCode)
    assert c == pt.make_code(m, rate=0.5)
    assert hash(c) == hash(pt.make_code(m, rate=0.5))
    back = jpt.PolarCode(c.level, c.frozen)
    assert back == jc
    np.testing.assert_array_equal(c.info_indices, jc.info_indices)
    # the node trees agree too
    assert pt.compile_code(c) == pt.compile_code(pt.code_from_jax(back))


def test_import_leaves_jax_out():
    src = ("import sys, polar_tpu_torch; "
           "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
           "or m == 'polar_tpu' or m.startswith('polar_tpu.')]; "
           "assert not bad, bad")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", src], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
