"""The element-sharded decoder at the sizes where the top tree levels span
shards, against polar_tpu and the golden vectors, on the CPU.

Over 8 positions on the CPU (``S = N / 8``), bit for bit:

* against JAX's XLA local decoder at m = 12, rates 0.25 and 0.75, and on
  the crafted mask of ``tests/test_seqpar_decode.py`` that puts a rep and
  an spc node above the shard level;
* against the reference's golden decodes at m = 12..14 (rate 0.5), over
  both transports, redundant and ``batch_split``;
* against JAX's own ``make_seqpar_decoder`` at m = 8 over 4 shards.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.parallel.seqpar import element_mesh as jax_element_mesh
from polar_tpu.parallel.seqpar_decode import \
    make_seqpar_decoder as jax_seqpar_decoder
from polar_tpu_torch.parallel.seqpar import element_mesh
from polar_tpu_torch.parallel.seqpar_decode import (_leaf_frozen,
                                                    make_seqpar_decoder)

VEC = Path(__file__).resolve().parent / "vectors" / "golden.npz"


def _llrs(n, b, seed):
    x = np.random.default_rng(seed).integers(-128, 128, (b, n)).astype(np.int8)
    x[0, :] = -128
    x[1, :] = 0
    return x


def _crafted_mask(m):
    """Left half all frozen but its last leaf (a rep node above the shard
    level), right half all free but its first leaf (an spc node)."""
    n = 1 << m
    mask = np.zeros(n, np.uint8)
    mask[: n // 2] = 1
    mask[n // 2 - 1] = 0
    mask[n // 2] = 1
    return mask


@pytest.mark.parametrize("case", ["rate0.25", "rate0.75", "crafted"])
def test_torch_seqpar_decoder_matches_jax_local_m12(case):
    m = 12
    if case == "crafted":
        jcode = jpt.PolarCode(m, _crafted_mask(m))
        code = pt.PolarCode(m, _crafted_mask(m))
        # rep and spc nodes above the shard level (2^9 over 8 positions)
        kinds, stack = set(), [pt.compile_code(code)]
        while stack:
            node = stack.pop()
            if node.level > m - 3:
                kinds.add(node.kind)
                stack.extend(c for c in (node.left, node.right) if c)
        assert {"rep", "spc"} <= kinds, kinds
    else:
        rate = float(case[4:])
        jcode, code = jpt.make_code(m, rate=rate), pt.make_code(m, rate=rate)
    llr = _llrs(code.N, 16, len(case))
    want = np.asarray(jax.jit(jpt.make_fastssc_decoder(
        jcode, output_dtype=jnp.int8))(jnp.asarray(llr)))
    mesh = element_mesh(["cpu"] * 8)
    for comm, split in (("ppermute", False), ("rdma", True)):
        got = make_seqpar_decoder(code, mesh, output="u", comm=comm,
                                  batch_split=split)(torch.from_numpy(llr))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{case} {comm} {split}")


@pytest.mark.parametrize("m", [12, 13, 14])
def test_torch_seqpar_decoder_golden_vectors(m):
    with np.load(VEC) as z:
        mask, llr, dec = (z[f"mask_{m}_50"], z[f"llr_{m}_50_0"],
                          z[f"dec_{m}_50_0"])
    code = pt.PolarCode(m, mask)
    mesh = element_mesh(["cpu"] * 8)
    for comm, split in (("rdma", False), ("ppermute", True)):
        got = make_seqpar_decoder(code, mesh, output="u", comm=comm,
                                  batch_split=split)(torch.from_numpy(llr))
        np.testing.assert_array_equal(got.numpy(), dec,
                                      err_msg=f"m={m} {comm} {split}")


def test_torch_seqpar_decoder_matches_jax_seqpar_m8():
    """JAX's own element-sharded decoder (ppermute) over 4 devices and the
    port's over 4 positions, u_full and u."""
    jcode, code = jpt.make_code(8, rate=0.5), pt.make_code(8, rate=0.5)
    llr = _llrs(code.N, 32, 4)
    jmesh = jax_element_mesh(jax.devices()[:4])
    mesh = element_mesh(["cpu"] * 4)
    for output in ("u_full", "u"):
        want = np.asarray(jax.jit(jax_seqpar_decoder(jcode, jmesh,
                                                     output=output))(
            jnp.asarray(llr))).astype(np.int8)
        got = make_seqpar_decoder(code, mesh, output=output)(
            torch.from_numpy(llr))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=output)


@pytest.mark.parametrize("m", [4, 7])
def test_torch_leaf_frozen_rebuilds_the_mask(m):
    """``_leaf_frozen`` (the local subtree's info scatter) rebuilds every
    node's frozen mask from its kinds."""
    for mask in (pt.make_code(m, rate=0.5).frozen, _crafted_mask(m)):
        code = pt.PolarCode(m, mask)
        np.testing.assert_array_equal(_leaf_frozen(pt.compile_code(code)),
                                      np.asarray(mask, np.uint8))
