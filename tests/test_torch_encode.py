"""polar_tpu_torch's transform and encoders against polar_tpu's and the
golden enc_* vectors (exact)."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.transform import polar_transform_stages as j_stages
from polar_tpu_torch.ops.transform import polar_transform_stages as t_stages

VEC = Path(__file__).resolve().parent / "vectors" / "golden.npz"


def _hard(rng, shape):
    """Hard symbols in {-1, 0, +1} (zeros exercise the tie handling)."""
    return rng.integers(-1, 2, shape).astype(np.int8)


@pytest.mark.parametrize("n", [2, 16, 256])
def test_transform_both_axes_match_jax(n):
    rng = np.random.default_rng(n)
    x = _hard(rng, (5, n))
    jt = jax.jit(jpt.polar_transform, static_argnums=1)
    want = np.asarray(jt(jnp.asarray(x), -1))
    np.testing.assert_array_equal(pt.polar_transform(torch.from_numpy(x)).numpy(), want)
    xt = np.ascontiguousarray(x.T)
    want0 = np.asarray(jt(jnp.asarray(xt), 0))
    np.testing.assert_array_equal(
        pt.polar_transform(torch.from_numpy(xt), axis=0).numpy(), want0)
    np.testing.assert_array_equal(want0, want.T)


@pytest.mark.parametrize("axis", [0, -1])
def test_transform_stage_split_commutes(axis):
    rng = np.random.default_rng(7)
    x = _hard(rng, (128, 3) if axis == 0 else (3, 128))
    full = pt.polar_transform(torch.from_numpy(x), axis=axis)
    tx = torch.from_numpy(x)
    split_a = t_stages(t_stages(tx, 1, 8, axis=axis), 8, 128, axis=axis)
    split_b = t_stages(t_stages(tx, 8, 128, axis=axis), 1, 8, axis=axis)
    np.testing.assert_array_equal(split_a, full)
    np.testing.assert_array_equal(split_b, full)
    np.testing.assert_array_equal(
        t_stages(tx, 4, 32, axis=axis).numpy(),
        np.asarray(jax.jit(j_stages, static_argnums=(1, 2, 3))(
            jnp.asarray(x), 4, 32, axis)))


@pytest.mark.parametrize("m,rate", [(2, 0.5), (5, 0.25), (8, 0.5), (10, 0.75)])
def test_encoders_match_jax(m, rate):
    jc = jpt.make_code(m, rate=rate)
    c = pt.code_from_jax(jc)
    rng = np.random.default_rng(m)
    msg = (1 - 2 * rng.integers(0, 2, (9, c.K))).astype(np.int8)
    tm = torch.from_numpy(msg)
    for jf, tf in ((jpt.encode, pt.encode),
                   (jpt.encode_systematic, pt.encode_systematic),
                   (jpt.extract_systematic, pt.extract_systematic)):
        np.testing.assert_array_equal(
            tf(c, tm).numpy(),
            np.asarray(jax.jit(jf, static_argnums=0)(jc, jnp.asarray(msg))))
    # systematic property: the message sits at the info positions
    cw = pt.encode_systematic(c, tm)
    np.testing.assert_array_equal(cw[:, c.info_indices].numpy(), msg)
    # a zero in the message propagates exactly as in the JAX encoder
    msg[0, 0] = 0
    np.testing.assert_array_equal(
        pt.extract_systematic(c, torch.from_numpy(msg)).numpy(),
        np.asarray(jax.jit(jpt.extract_systematic, static_argnums=0)(
            jc, jnp.asarray(msg))))


def test_encoders_golden_vectors():
    with np.load(VEC) as z:
        vec = dict(z.items())
    n = 0
    for key in vec:
        if not key.startswith("mask_"):
            continue
        _, m, rk = key.split("_")
        code = pt.PolarCode(int(m), vec[key])
        msg = torch.from_numpy(vec[f"enc_msg_{m}_{rk}"])
        np.testing.assert_array_equal(pt.encode_systematic(code, msg).numpy(),
                                      vec[f"enc_sys_{m}_{rk}"], err_msg=key)
        np.testing.assert_array_equal(pt.encode(code, msg).numpy(),
                                      vec[f"enc_nonsys_{m}_{rk}"], err_msg=key)
        n += 1
    assert n >= 20


def test_message_shape_is_checked():
    c = pt.make_code(4, rate=0.5)
    with pytest.raises(ValueError):
        pt.encode(c, torch.ones(2, c.K + 1, dtype=torch.int8))
