"""The port's decoders against polar_tpu's (exact).

* the eager decoder in all four output modes against
  ``make_fastssc_decoder`` on full-range int8 LLRs (−128 and zero ties
  included), and against the golden llr_* → dec_* vectors;
* the CUDA decoder's plain version, element-major, against the Pallas SSA
  kernel in interpret mode;
* the wrapper's dispatch: a CPU tensor runs the plain version and launches
  nothing; the build fails loudly without nvcc.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.decoder_kernel import make_pallas_decoder
from polar_tpu_torch.decode.auto import make_kernel_decoder
from polar_tpu_torch.ops.cuda import build, decoder_kernel

VEC = Path(__file__).resolve().parent / "vectors" / "golden.npz"
MODES = ("u", "systematic", "codeword", "both")


def _llrs(rng, b, n):
    x = rng.integers(-128, 128, (b, n)).astype(np.int8)
    x[0, :] = -128          # saturation edge
    x[1, :] = 0             # all-zero ties
    x[2, ::2] = 0
    x[3, :] = np.where(np.arange(n) % 3 == 0, -128, 127)
    return x


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _expected(u, cw, info, mode, axis):
    """The JAX decoder's four outputs from its ``both`` output: u, the
    codeword estimate at the info positions, the codeword estimate, both."""
    u, cw = np.asarray(u), np.asarray(cw)
    return {"u": u, "systematic": np.take(cw, info, axis=axis),
            "codeword": cw, "both": (u, cw)}[mode]


@pytest.mark.parametrize("m", range(2, 11))
def test_eager_decoder_matches_jax_all_modes(m):
    jc = jpt.make_code(m, rate=0.5)
    c = pt.code_from_jax(jc)
    llr = _llrs(np.random.default_rng(m), 48, c.N)
    u, cw = jax.jit(jpt.make_fastssc_decoder(jc, output="both"))(jnp.asarray(llr))
    if m <= 6:  # JAX's systematic output is its codeword estimate at the info rows
        np.testing.assert_array_equal(
            np.asarray(jax.jit(jpt.make_fastssc_decoder(jc, output="systematic"))(
                jnp.asarray(llr))), np.asarray(cw)[:, c.info_indices])
    for mode in MODES:
        _same(pt.make_fastssc_decoder(c, output=mode)(torch.from_numpy(llr)),
              _expected(u, cw, c.info_indices, mode, -1))


def test_eager_decoder_lane_major_and_compute_modes():
    jc = jpt.make_code(7, rate=0.25)
    c = pt.code_from_jax(jc)
    llr = _llrs(np.random.default_rng(1), 40, c.N)
    lt = torch.from_numpy(np.ascontiguousarray(llr.T))
    u, cw = jax.jit(jpt.make_fastssc_decoder(jc, output="both").lane_major)(
        jnp.asarray(llr.T))
    for mode in MODES:
        _same(pt.make_fastssc_decoder(c, output=mode).lane_major(lt),
              _expected(u, cw, c.info_indices, mode, 0))
    base = pt.make_fastssc_decoder(c)(torch.from_numpy(llr))
    for compute in ("int8", "qfloat", "qfloat-f32"):
        got = pt.make_fastssc_decoder(c, compute=compute,
                                      output_dtype=torch.int8)(torch.from_numpy(llr))
        np.testing.assert_array_equal(got.numpy(), base.numpy())
    fl = np.random.default_rng(2).normal(0, 3, (8, c.N)).astype(np.float32)
    want = jax.jit(jpt.make_fastssc_decoder(jc, compute="float32"))(jnp.asarray(fl))
    got = pt.make_fastssc_decoder(c, compute="float32")(torch.from_numpy(fl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eager_decoder_golden_vectors():
    with np.load(VEC) as z:
        vec = dict(z.items())
    batches = 0
    for key in vec:
        if not key.startswith("mask_"):
            continue
        _, m, rk = key.split("_")
        dec = pt.make_fastssc_decoder(pt.PolarCode(int(m), vec[key]))
        i = 0
        while f"llr_{m}_{rk}_{i}" in vec:
            got = dec(torch.from_numpy(vec[f"llr_{m}_{rk}_{i}"]))
            np.testing.assert_array_equal(got.numpy(), vec[f"dec_{m}_{rk}_{i}"],
                                          err_msg=f"m={m} rate={rk} batch={i}")
            batches += 1
            i += 1
        fkey = f"fllr_{m}_{rk}"
        if fkey in vec:
            fdec = pt.make_fastssc_decoder(pt.PolarCode(int(m), vec[key]),
                                           compute="float32")
            np.testing.assert_array_equal(
                fdec(torch.from_numpy(vec[fkey])).numpy(), vec[f"fdec_{m}_{rk}"])
    assert batches >= 50


@pytest.mark.parametrize("m", [5, 6])
def test_decode_plain_matches_pallas_ssa_interpret(m):
    jc = jpt.make_code(m, rate=0.5)
    c = pt.code_from_jax(jc)
    llr = _llrs(np.random.default_rng(10 + m), 256, c.N)
    lt = torch.from_numpy(np.ascontiguousarray(llr.T))
    program = pt.compile_program(c)
    # element-major, both tracks of the Pallas kernel
    for want_cw in (False, True):
        pallas = make_pallas_decoder(jc, frame_tile=128, interpret=True,
                                     style="ssa", output="both" if want_cw else "u")
        want = pallas.lane_major(jnp.asarray(llr.T))
        u, cw = decoder_kernel.decode_plain(program, c.frozen, lt, want_cw)
        _same((u, cw) if want_cw else u, want)
        if not want_cw:
            assert cw is None
    # the frame-major entries (transposes and info gather) of both packages
    for mode in ("systematic", "codeword"):
        pallas = make_pallas_decoder(jc, frame_tile=128, interpret=True,
                                     style="ssa", output=mode)
        _same(make_kernel_decoder(c, output=mode)(torch.from_numpy(llr)),
              pallas(jnp.asarray(llr)))


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    c = pt.make_code(6, rate=0.5)
    llr = torch.from_numpy(_llrs(np.random.default_rng(4), 64, c.N).T.copy())
    before = dict(decoder_kernel.launches)
    plain = decoder_kernel.plain_calls["decode_plain"]
    u, cw = decoder_kernel.decode(pt.compile_program(c), c.frozen, llr, True)
    assert decoder_kernel.launches == before
    assert decoder_kernel.plain_calls["decode_plain"] == plain + 1
    assert u.shape == (c.K, 64) and cw.shape == (c.N, 64)
    dec, desc = pt.make_auto_decoder(c, output="systematic", device="cpu")
    assert desc == "eager"
    sysmsg = dec(llr.T.contiguous())
    np.testing.assert_array_equal(sysmsg.numpy(), cw[c.info_indices].T.numpy())


def test_plain_rejects_foreign_program():
    a, b = pt.make_code(5, rate=0.25), pt.make_code(5, rate=0.75)
    with pytest.raises(ValueError):
        decoder_kernel.decode_plain(pt.compile_program(a), b.frozen,
                                    torch.zeros(32, 4, dtype=torch.int8), False)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())

