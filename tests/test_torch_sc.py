"""The port's SC decoder against polar_tpu's, on the CPU.

int8: bit-exact with the JAX decoder in all four outputs on full-range
int8 LLRs that include −128 (numpy, from a seed). Float: SC's decisions
equal the port's Fast-SSC's where no ties occur (the pruning is
decision-equivalent, Sarkis et al. 2013; ``tests/test_decoders.py:40-52``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt


@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 7, 8])
def test_sc_int8_matches_jax(m):
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    rng = np.random.default_rng(m)
    llr = rng.integers(-128, 128, (48, jc.N)).astype(np.int8)
    llr[0, :] = -128
    llr[1, ::2] = 0
    for output in ("u", "systematic", "codeword", "both"):
        want = jpt.make_sc_decoder(jc, output=output)(jnp.asarray(llr))
        got = pt.make_sc_decoder(code, output=output)(torch.from_numpy(llr))
        want, got = ((want, got) if output == "both" else ((want,), (got,)))
        for a, b in zip(got, want):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("m", [3, 5, 7, 9])
def test_sc_float_decisions_equal_fastssc(m):
    rng = np.random.default_rng(m + 100)
    code = pt.make_code(m, rate=0.5)
    llr = torch.from_numpy(rng.normal(size=(64, code.N)).astype(np.float32) * 3)
    u_sc = pt.make_sc_decoder(code)(llr)
    u_fast = pt.make_fastssc_decoder(code)(llr)
    # tie-freedom witness: a zero output would make the sign comparison
    # vacuous
    assert bool((u_sc != 0).all()) and bool((u_fast != 0).all())
    assert torch.equal(torch.sign(u_sc), torch.sign(u_fast))


def test_sc_noiseless_roundtrip_and_modes():
    code = pt.make_code(6, rate=0.5)
    rng = np.random.default_rng(6)
    msg = torch.from_numpy((1 - 2 * rng.integers(0, 2, (8, code.K))).astype(np.int8))
    llr = (pt.encode_systematic(code, msg).to(torch.int32) * 96).to(torch.int8)
    assert torch.equal(pt.make_sc_decoder(code, output="systematic")(llr), msg)
    with pytest.raises(ValueError, match="output mode"):
        pt.make_sc_decoder(code, output="bits")
