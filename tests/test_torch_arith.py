"""polar_tpu_torch.ops.arith against polar_tpu.ops.arith, exhaustively.

Every int8 pair (65,536) for the binary ops, every hard value for madd's
first operand, and the quantizer's half-to-even ties.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.ops import arith as jar
from polar_tpu_torch.ops import arith as tar

ALL = np.arange(-128, 128, dtype=np.int8)
A, B = (x.ravel() for x in np.meshgrid(ALL, ALL))


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("op", ["qadd", "prod"])
def test_binary_ops_all_pairs(op):
    want = np.asarray(getattr(jar.Int8Arith(), op)(_j(A), _j(B)))
    got = getattr(tar.Int8Arith(), op)(_t(A), _t(B)).numpy()
    np.testing.assert_array_equal(got, want)
    # the functional facade dispatches int8 to the same ops
    np.testing.assert_array_equal(getattr(tar, op)(_t(A), _t(B)).numpy(), want)


@pytest.mark.parametrize("h", [-1, 0, 1])
def test_madd_all_pairs(h):
    hard = np.full(A.shape, h, dtype=np.int8)
    want = np.asarray(jar.Int8Arith().madd(_j(hard), _j(A), _j(B)))
    got = tar.Int8Arith().madd(_t(hard), _t(A), _t(B)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["qabs", "signum", "decide"])
def test_unary_ops_all_values(op):
    want = np.asarray(getattr(jar.Int8Arith(), op)(_j(ALL)))
    got = getattr(tar.Int8Arith(), op)(_t(ALL)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quant_half_to_even():
    x = np.concatenate([
        np.arange(-130.5, 130.5, 0.5, dtype=np.float32),  # every tie
        np.random.default_rng(0).normal(0, 80, 4096).astype(np.float32),
        np.array([-1e9, 1e9, -0.0, 0.0], dtype=np.float32)])
    want = np.asarray(jar.Int8Arith().quant(_j(x)))
    np.testing.assert_array_equal(tar.Int8Arith().quant(_t(x)).numpy(), want)
    np.testing.assert_array_equal(tar.quant(_t(x)).numpy(), want)
    assert tar.quant(_t(np.array([0.5, 1.5, 2.5], np.float32))).tolist() == [0, 2, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_qfloat_equals_int8(dtype):
    i8 = tar.Int8Arith()
    qf = tar.QuantFloatArith(dtype)
    a, b = _t(A), _t(B)
    af, bf = a.to(dtype), b.to(dtype)
    for op in ("qadd", "prod"):
        want = getattr(i8, op)(a, b)
        np.testing.assert_array_equal(getattr(qf, op)(af, bf).to(torch.int8), want)
    for h in (-1, 0, 1):
        hard = torch.full(a.shape, h, dtype=torch.int8)
        np.testing.assert_array_equal(
            qf.madd(hard.to(dtype), af, bf).to(torch.int8), i8.madd(hard, a, b))
    for op in ("qabs", "signum", "decide"):
        np.testing.assert_array_equal(getattr(qf, op)(af).to(torch.int8),
                                      getattr(i8, op)(a))


def test_float_arith_matches_jax():
    rng = np.random.default_rng(3)
    a, b, c = (rng.normal(0, 10, 1000).astype(np.float32) for _ in range(3))
    a[:10] = 0.0
    ja, ta = jar.FloatArith(jnp.float32), tar.FloatArith(torch.float32)
    for op, args in (("prod", (a, b)), ("madd", (a, b, c)), ("qadd", (a, b)),
                     ("decide", (a,)), ("qabs", (a,))):
        want = np.asarray(getattr(ja, op)(*map(_j, args)))
        got = getattr(ta, op)(*map(_t, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0, err_msg=op)
