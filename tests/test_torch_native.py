"""The port's native construction and compiler (``polar_tpu_torch.code.native``)
against its numpy implementation and the JAX package's.

The cases of ``tests/test_native.py``; here they run, since the port builds
its own extension (``polar_tpu_torch/csrc/native/polar_native.c``) with the
host C compiler at first use. Masks and programs must be equal; logpe and
the dual domains agree to transcendental-library rounding, with
``test_native.py``'s tolerances.
"""

import math
import sys

import numpy as np
import pytest

from polar_tpu.code import compiler as j_compiler
from polar_tpu.code import construction as j_construction
import polar_tpu_torch as pt
from polar_tpu_torch.code import compiler, construction, native


def test_the_extension_is_the_ports_own():
    assert native.have_native()
    module = native.load()
    assert module.__name__ == native.MODULE == "_polar_tpu_torch_native"
    assert module.__file__ == str(native.library_path())
    assert native.library_path().parent == native.BUILD_DIR
    assert "_polar_native" not in sys.modules or (
        sys.modules["_polar_native"] is not module)


def _masks(fn, *args):
    """The mask of ``fn`` by name from the extension, the port's numpy and
    the JAX package's numpy."""
    return [getattr(mod, fn)(*args)
            for mod in (native, construction, j_construction)]


@pytest.mark.parametrize("m", [1, 4, 8, 12, 16])
def test_native_fixed_k_matches_numpy(m):
    a, b, c = _masks("frozen_mask_fixed_k", m, (1 << m) // 2, math.exp(-1))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("m", [3, 8, 12])
@pytest.mark.parametrize("pe,th", [(0.5, 0.5), (0.3, 1e-7)])
def test_native_threshold_matches_numpy(m, pe, th):
    a, b, c = _masks("frozen_mask_threshold", m, pe, th)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("m", [2, 6, 10, 14])
def test_native_program_matches_numpy(m):
    for rate in (0.25, 0.5, 0.75):
        mask = native.frozen_mask_fixed_k(m, int(rate * (1 << m)), math.exp(-1))
        a = native.compile_program(mask, m)
        np.testing.assert_array_equal(
            a, compiler.compile_program(pt.PolarCode(m, mask)))
        np.testing.assert_array_equal(
            a, j_compiler.compile_program(j_construction.PolarCode(m, mask)))


def test_native_logpe_matches_numpy():
    for m in (4, 10, 15):
        a = native.bhattacharyya_logpe(m, 0.37)
        for b in (construction.bhattacharyya_logpe(m, 0.37),
                  j_construction.bhattacharyya_logpe(m, 0.37)):
            np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("pe", [1e-9, 0.01, 0.2, 0.5, 0.80, 1 - 1e-9])
@pytest.mark.parametrize("m", [1, 6, 12, 18])
def test_native_dual_matches_numpy_where_it_matters(m, pe):
    """lp relative everywhere (the primary sort key); lq absolute 1e-12 in
    the cancellation zone near 0, relative elsewhere (test_native.py)."""
    lp_c, lq_c = native.bhattacharyya_dual(m, pe)
    for lp, lq in (construction.bhattacharyya_dual(m, pe),
                   j_construction.bhattacharyya_dual(m, pe)):
        np.testing.assert_allclose(lp_c, lp, rtol=3e-12, atol=1e-12)
        np.testing.assert_allclose(lq_c, lq, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("pe", [1e-6, 0.1, 0.5, 0.9, 1 - 1e-6])
def test_native_fixed_k_matches_in_tails(pe):
    """Mask parity at extreme design points, where the rankings are decided
    by the saturating domain's tie-breaks."""
    m, n = 14, 1 << 14
    for k in (n // 8, n // 2, 7 * n // 8):
        a, b, c = _masks("frozen_mask_fixed_k", m, k, pe)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_native_large_n():
    """Construction and compile at N = 2^20 agree on K and frame the
    program."""
    m = 20
    mask = native.frozen_mask_fixed_k(m, 1 << 19)
    assert int((mask == 0).sum()) == 1 << 19
    prog = native.compile_program(mask, m)
    assert prog[0] == m and prog[-1] == 255


def test_native_errors():
    with pytest.raises(ValueError):
        native.frozen_mask_fixed_k(40, 10)
    with pytest.raises(ValueError):
        native.compile_program(np.array([1, 2], np.uint8), 4)


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """With no usable compiler the build raises, have_native says so, and
    every function raises rather than answer from numpy."""
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "no-such-cc")
    monkeypatch.setattr(native.sysconfig, "get_config_var", lambda _: None)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(native.NativeBuildError, match="no C compiler"):
        native.build()
    assert not native.have_native()
    with pytest.raises(native.NativeBuildError):
        native.frozen_mask_fixed_k(4, 8)
    assert list(tmp_path.iterdir()) == []


def test_a_fresh_build_is_atomic_and_loads(monkeypatch, tmp_path):
    """A build into an empty directory leaves exactly the named library
    (the temporary file renamed over it), which loads; a second build
    finds it."""
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build()
    assert path == native.library_path() and path.parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    mtime = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(native.frozen_mask_fixed_k(8, 128),
                                  construction.frozen_mask_fixed_k(8, 128))
