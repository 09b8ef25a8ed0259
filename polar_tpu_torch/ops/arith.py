"""Dtype-polymorphic decoder arithmetic, on torch tensors.

The port of ``polar_tpu.ops.arith``: the small op vocabulary the polar
encoder and decoder are written in, for three numeric modes.

* :class:`Int8Arith` — saturating int8 fixed point, bit-exact with the
  reference's SIMD int8 semantics (``polar_helper.hh:113-173``, the AVX2
  ``vsign``-based path), including the ``-127`` clamps guarding the
  asymmetric int8 range. torch int8 addition wraps, so every saturating
  op upcasts to int16 and clamps before narrowing.
* :class:`FloatArith` — plain floating point (``polar_helper.hh:63-111``).
* :class:`QuantFloatArith` — int8 semantics carried in a float dtype: LLRs
  are small integers (|x| <= 128; intermediates pre-clamp <= 256), exact
  in float32, float16 and bfloat16, so saturation becomes a clamp and the
  results are bit-identical to :class:`Int8Arith`.

Semantics cheat sheet (int8 / qfloat):
  qadd(a, b)      = sat8(a + b)                 saturating add
  qabs(a)         = |max(a, -127)|              abs that cannot overflow
  prod(a, b)      = sign(a)*sign(b)*min(qabs(a), qabs(b))   min-sum "f"
  madd(a, b, c)   = sat8(sign(a)*max(b, -127) + c)          "g" update
  qmul(a, b)      = a * b  (hard values in {-1,0,1} only)
  signum(a)       = -1/0/+1
  decide(a)       = -1 if a < 0 else +1
  flip(a,b,c,d)   = qmul(a, b) where c == d else a
  quant(x)        = clamp(rint(x), -128, 127), ties to even
"""

from __future__ import annotations

import torch

I8_MIN = -128
I8_MAX = 127


class _ArithBase:
    """Shared elementwise ops; subclasses define the saturating pieces."""

    dtype: torch.dtype

    def signum(self, a):
        """-1 / 0 / +1 (``polar_helper.hh:125-128``)."""
        return torch.sign(a)

    def qmin(self, a, b):
        return torch.minimum(a, b)

    def qmul(self, a, b):
        """Hard-decision multiply; only applied to values in {-1, 0, +1},
        where the reference's ``vsign`` equals plain multiplication."""
        return a * b

    def flip(self, a, b, c, d):
        """qmul(a, b) where c == d, else a (``polar_helper.hh:169-172``,
        the SPC weakest-bit flip: every tied minimum flips)."""
        return torch.where(c == d, self.qmul(a, b), a)


class Int8Arith(_ArithBase):
    """Saturating int8, bit-exact with ``PolarHelper<SIMD<int8_t,W>>``."""

    dtype = torch.int8

    @staticmethod
    def _sat8(x16):
        return x16.clamp(I8_MIN, I8_MAX).to(torch.int8)

    def signum(self, a):
        return a.clamp(-1, 1)

    def decide(self, a):
        """+1 for a >= 0 else -1 (``polar_helper.hh:129-132``)."""
        return torch.where(a < 0, -1, 1).to(a.dtype)

    def qabs(self, a):
        """|max(a, -127)| — guards -128 (``polar_helper.hh:133-136``)."""
        return a.clamp(min=-127).abs()

    def qadd(self, a, b):
        return self._sat8(a.to(torch.int16) + b.to(torch.int16))

    def prod(self, a, b):
        """Min-sum "f" (``polar_helper.hh:153-160``)."""
        s = self.signum(a).to(torch.int16) * self.signum(b).to(torch.int16)
        return (s * torch.minimum(self.qabs(a), self.qabs(b))).to(a.dtype)

    def madd(self, a, b, c):
        """"g": sat8(sign(a)*max(b,-127) + c) (``polar_helper.hh:161-168``).

        ``a`` is a hard decision in {-1, 0, +1} by the decoder contract,
        so ``sign(a) == a``."""
        p = a.to(torch.int16) * b.clamp(min=-127).to(torch.int16)
        return self._sat8(p + c.to(torch.int16))

    def quant(self, x):
        """clamp(rint(x), -128, 127) (``polar_helper.hh:194-198``)."""
        return torch.round(x).clamp(I8_MIN, I8_MAX).to(torch.int8)


class FloatArith(_ArithBase):
    """Unsaturated float path (``polar_helper.hh:63-111``)."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def decide(self, a):
        """copysign(1, a) (``polar_helper.hh:79-82``)."""
        return torch.copysign(torch.ones_like(a), a)

    def qabs(self, a):
        return a.abs()

    def qadd(self, a, b):
        return a + b

    def prod(self, a, b):
        return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())

    def madd(self, a, b, c):
        return a * b + c

    def quant(self, x):
        return x.to(self.dtype)


class QuantFloatArith(_ArithBase):
    """Int8 saturation semantics carried in a float dtype.

    Inputs and outputs are integer-valued floats in [-128, 127]; every op
    keeps intermediates within |x| <= 256, exact in bfloat16 and wider, so
    results are bit-identical to :class:`Int8Arith`.
    """

    def __init__(self, dtype=torch.bfloat16):
        self.dtype = dtype

    def signum(self, a):
        return a.clamp(-1, 1)

    def decide(self, a):
        return torch.where(a < 0, -1.0, 1.0).to(a.dtype)

    def qabs(self, a):
        return a.clamp(min=-127).abs()

    def qadd(self, a, b):
        return (a + b).clamp(I8_MIN, I8_MAX)

    def prod(self, a, b):
        s = self.signum(a) * self.signum(b)
        return s * torch.minimum(self.qabs(a), self.qabs(b))

    def madd(self, a, b, c):
        # `a` is a hard decision in {-1, 0, +1}, so sign(a) == a
        return (a * b.clamp(min=-127) + c).clamp(I8_MIN, I8_MAX)

    def quant(self, x):
        return torch.round(x).clamp(I8_MIN, I8_MAX).to(self.dtype)


def arith_for(dtype) -> _ArithBase:
    """Default arithmetic for a working dtype: integer → saturating int8,
    floats → plain float min-sum."""
    if not dtype.is_floating_point:
        return Int8Arith()
    return FloatArith(dtype)


# Functional facade, dispatching on the input dtype: integer dtypes →
# Int8Arith, floats → FloatArith.

def _dispatch(x) -> _ArithBase:
    return arith_for(x.dtype)


def signum(a):
    return torch.sign(a)


def decide(a):
    return _dispatch(a).decide(a)


def qabs(a):
    return _dispatch(a).qabs(a)


def qmin(a, b):
    return torch.minimum(a, b)


def qadd(a, b):
    return _dispatch(a).qadd(a, b)


def qmul(a, b):
    return a * b


def prod(a, b):
    return _dispatch(a).prod(a, b)


def madd(a, b, c):
    return _dispatch(a).madd(a, b, c)


def flip(a, b, c, d):
    return _dispatch(a).flip(a, b, c, d)


def quant(x, dtype=torch.int8):
    """LLR quantizer: round half to even then clamp for integer dtypes
    (``polar_helper.hh:194-198``), identity cast for floats."""
    if not dtype.is_floating_point:
        return torch.round(x).clamp(I8_MIN, I8_MAX).to(dtype)
    return x.to(dtype)
