"""The fused step's plain version and its wrapper's rules (CPU).

* ``step_kernel.step_plain`` against the Pallas step kernel in interpret
  mode (``prng="inject"``) on injected normals that land exactly on
  quantization half-steps, where round-half-to-even decides the LLR, at
  rates 0.25, 0.5 and 0.75, both modes. At the SNR at which σ = 0.5 and
  2/σ² = 8 exactly the product σ·n is exact, so the half-steps do not
  depend on whether ``cw + σ·n`` is rounded once or twice, and the two
  agree outright. At a general σ they do depend on it: XLA:CPU contracts
  the JAX chain's multiply-add under jit (rounded once, on a host with
  FMA), while the port rounds the product and the sum apart (its kernels
  are built with ``-fmad=false``). There the Pallas step's counters are
  held to the port's counters on the once-rounded LLRs, and the tie
  entries where the two roundings differ are pinned by count;
* the tile step's shared-memory arithmetic and the level rule between it
  and the walk (``STEP_TILE_MAX_LEVEL``);
* on CPU tensors both styles run the plain version and launch nothing.
The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.step_kernel import _snr_params, make_pallas_step
from polar_tpu_torch.ops.cuda import decoder_kernel, step_kernel

BATCH = 128
SNR_DB = 0.5
# float32(3.0103) dB: sigma = 0.5 and 2 / sigma^2 = 8.0 exactly, in both
# packages
EXACT_SNR_DB = 3.0102999210357666


def _params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


def _half_step_inputs(code, systematic, params, seed):
    """Message symbols (N, B) and float32 normals (N, B) such that
    ``scale * (cw + sigma * normal)``, each product and sum rounded to
    float32, is exactly j + 1/2 for most entries (j in [-40, 40)); the
    count of exact half-steps is returned too."""
    rng = np.random.default_rng(seed)
    n = code.N
    msg = (1 - 2 * rng.integers(0, 2, (n, BATCH))).astype(np.int8)
    # the transmitted codeword, from the plain front on zero noise
    _, cw, _, _ = step_kernel._front_plain(
        code.frozen, params, systematic, torch.from_numpy(msg),
        torch.zeros((n, BATCH)), None, 0, 0, None)
    cw = cw.numpy().astype(np.float32)
    sigma, scale = (np.float32(p) for p in params)
    target = rng.integers(-40, 40, (n, BATCH)).astype(np.float32) + 0.5
    ideal = ((target.astype(np.float64) / scale - cw) / sigma).astype(np.float32)
    nrm = ideal.copy()
    exact = np.zeros(nrm.shape, bool)
    for k in range(-12, 13):   # a few ulps around the ideal normal
        cand = ideal
        for _ in range(abs(k)):
            cand = np.nextafter(cand, np.float32(np.inf if k > 0 else -np.inf))
        q = scale * (cw + sigma * cand)
        hit = (q == target) & ~exact
        nrm[hit] = cand[hit]
        exact |= hit
    return msg, nrm, int(exact.sum())


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
def test_step_plain_matches_pallas_step_on_half_steps(rate, systematic):
    jc = jpt.make_code(6, rate=rate)
    code = pt.code_from_jax(jc)
    params = _params(EXACT_SNR_DB)
    assert params == (0.5, 8.0) == pt.channel.snr_params(EXACT_SNR_DB)
    msg, nrm, exact = _half_step_inputs(code, systematic, params,
                                        int(rate * 8) + systematic)
    assert exact == msg.size
    step = make_pallas_step(jc, frame_tile=BATCH, interpret=True,
                            prng="inject", systematic=systematic)
    want = {k: int(v) for k, v in
            step(jnp.asarray(msg), jnp.asarray(nrm), EXACT_SNR_DB).items()}
    t = step_kernel.step_plain(pt.compile_program(code), code.frozen, params,
                               systematic, msg_t=torch.from_numpy(msg),
                               normals_t=torch.from_numpy(nrm))
    assert dict(zip(step_kernel.COUNTERS, t.tolist())) == want
    assert want["quantization_erasures"] + want["awgn_errors"] > 0


# (rate, systematic) -> the entries of ``_half_step_inputs`` at SNR_DB
# where rounding ``cw + σ·n`` once and rounding it twice give different
# LLRs: all of them within two float32 ulps of a half-step
ROUNDING_GAP = {(0.25, True): 855, (0.25, False): 865, (0.5, True): 886,
                (0.5, False): 868, (0.75, True): 878, (0.75, False): 895}


def _rounded_once(cw, nrm, params):
    """The LLRs of ``scale * (cw + σ·n)`` with ``cw + σ·n`` rounded to
    float32 once, as a fused multiply-add rounds it."""
    sigma, scale = (np.float64(p) for p in params)
    y = (cw.astype(np.float64) + sigma * nrm.astype(np.float64))
    q = np.float32(scale) * y.astype(np.float32)
    return np.clip(np.rint(q), -128, 127)


def _near_half(q):
    """Whether each float32 ``q`` lies within two ulps of j + 1/2."""
    return np.abs(q - np.floor(q) - 0.5) <= 2 * np.spacing(np.abs(q))


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
def test_pallas_step_rounds_once_where_step_plain_rounds_twice(rate,
                                                                systematic):
    jc = jpt.make_code(6, rate=rate)
    code = pt.code_from_jax(jc)
    params = _params(SNR_DB)
    msg, nrm, exact = _half_step_inputs(code, systematic, params,
                                        int(rate * 8) + systematic)
    step = make_pallas_step(jc, frame_tile=BATCH, interpret=True,
                            prng="inject", systematic=systematic)
    want = {k: int(v) for k, v in
            step(jnp.asarray(msg), jnp.asarray(nrm), SNR_DB).items()}
    assert exact > msg.size // 2
    frozen = np.asarray(code.frozen, np.uint8)
    program = pt.compile_program(code)
    llr, cw, u0, frz = step_kernel._front_plain(
        frozen, params, systematic, torch.from_numpy(msg),
        torch.from_numpy(nrm), None, 0, 0, None)
    once = _rounded_once(cw.numpy(), nrm, params)
    sigma, scale = (np.float32(p) for p in params)
    q = scale * (cw.numpy().astype(np.float32) + sigma * nrm)
    gap = llr.numpy() != once
    assert gap.sum() == ROUNDING_GAP[(rate, systematic)]
    assert _near_half(q[gap]).all()
    assert (np.abs(once[gap] - llr.numpy()[gap]) == 1).all()
    # the reference's counters are the port's on the once-rounded LLRs
    got = step_kernel.counts_plain(
        program, frozen, systematic, torch.from_numpy(once.astype(np.int8)),
        cw, u0, frz)
    assert dict(zip(step_kernel.COUNTERS, got.tolist())) == want
    # and the port's step counts its own (twice-rounded) LLRs
    assert step_kernel.step_plain(
        program, code.frozen, params, systematic, msg_t=torch.from_numpy(msg),
        normals_t=torch.from_numpy(nrm)).tolist() == step_kernel.counts_plain(
            program, frozen, systematic, llr, cw, u0, frz).tolist()


def test_half_steps_round_to_even_and_the_reference_contracts():
    """At a general σ the port rounds ``σ·n`` and ``cw + σ·n`` apart (as
    numpy's float32 ops do here) and its half-steps round to even. The
    JAX chain under jit on XLA:CPU differs from it only where it rounds
    ``cw + σ·n`` once (a fused multiply-add)."""
    code = pt.make_code(6, rate=0.5)
    params = _params(SNR_DB)
    msg, nrm, exact = _half_step_inputs(code, True, params, 1)
    llr, cw, _, _ = step_kernel._front_plain(
        code.frozen, params, True, torch.from_numpy(msg),
        torch.from_numpy(nrm), None, 0, 0, None)
    llr, cw = llr.numpy(), cw.numpy().astype(np.float32)
    sigma, scale = (np.float32(p) for p in params)
    q = scale * (cw + sigma * nrm)
    np.testing.assert_array_equal(llr, np.clip(np.rint(q), -128, 127))
    half = q - np.floor(q) == 0.5
    assert half.sum() == exact > llr.size // 2
    assert (llr[half] % 2 == 0).all()
    jitted = np.asarray(jax.jit(
        lambda c, n: jnp.clip(jnp.rint(scale * (c + sigma * n)), -128, 127))(
            cw, nrm))
    once = _rounded_once(cw, nrm, params)
    np.testing.assert_array_equal(jitted, once)
    gap = jitted != llr
    assert gap.sum() == 874 and _near_half(q[gap]).all()


def test_tile_step_shared_memory_and_the_level_rule():
    dk, sk = decoder_kernel, step_kernel
    top = sk.STEP_TILE_MAX_LEVEL
    # soft, hard, root (and the cw stack in systematic mode), n bytes a
    # frame each
    for m in (2, 10, top):
        n = 1 << m
        assert dk.tile_bytes(n, True, root=True) == 4 * n * dk.WHOLE_FRAMES
        assert dk.tile_bytes(n, False, root=True) == 3 * n * dk.WHOLE_FRAMES
    assert dk.tile_bytes(1 << top, True, root=True) <= dk.SCRATCH_SMEM_BYTES
    assert dk.tile_bytes(2 << top, True, root=True) > dk.SCRATCH_SMEM_BYTES
    assert top == 12
    # from level 2 (whole 4-row Philox blocks) to the limit, the tile step
    assert sk.step_kernel_name(2) == "walk"
    for m in range(2, top + 1):
        assert sk.step_kernel_name(1 << m) == "tile"
    for m in (top + 1, pt.ber.STEP_KERNEL_MAX_LEVEL):
        assert sk.step_kernel_name(1 << m) == "walk"
    assert pt.ber.STEP_KERNEL_MAX_LEVEL == 16


@pytest.mark.parametrize("style", ["ssa", "walk"])
@pytest.mark.parametrize("systematic", [True, False])
def test_cpu_tensors_run_plain_in_every_style(style, systematic):
    code = pt.make_code(5, rate=0.5)
    program = pt.compile_program(code)
    msg, nrm, _ = _half_step_inputs(code, systematic, _params(SNR_DB), 3)
    before = dict(step_kernel.launches)
    plain = step_kernel.plain_calls["step_plain"]
    kw = dict(msg_t=torch.from_numpy(msg), normals_t=torch.from_numpy(nrm))
    got = step_kernel.step(program, code.frozen, _params(SNR_DB), systematic,
                           style=style, **kw)
    want = step_kernel.step_plain(program, code.frozen, _params(SNR_DB),
                                  systematic, **kw)
    assert torch.equal(got, want)
    native = dict(seeds=(4, 5), call=1, batch=64, device="cpu")
    assert torch.equal(
        step_kernel.step(program, code.frozen, _params(SNR_DB), systematic,
                         style=style, **native),
        step_kernel.step_plain(program, code.frozen, _params(SNR_DB),
                               systematic, **native))
    assert step_kernel.launches == before
    assert step_kernel.plain_calls["step_plain"] == plain + 4


def test_step_style_is_checked_and_reaches_make_step():
    code = pt.make_code(5, rate=0.5)
    with pytest.raises(ValueError, match="style"):
        step_kernel.step(pt.compile_program(code), code.frozen,
                         _params(SNR_DB), True, seeds=(1, 2), batch=8,
                         device="cpu", style="tile")
    with pytest.raises(ValueError, match="style"):
        pt.ber.make_step(code, fused=True, step_style="tile", device="cpu")
    counts = []
    for style in ("ssa", "walk"):
        gen = torch.Generator()
        gen.manual_seed(7)
        step = pt.ber.make_step(code, fused=True, step_style=style,
                                device="cpu")
        counts.append({k: int(v) for k, v in step(gen, -1.0, 32).items()})
    assert counts[0] == counts[1]
