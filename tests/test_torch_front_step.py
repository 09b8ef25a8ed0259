"""The port's element-major front step against polar_tpu, on the CPU: the
whole-block front, decode+count and the middle stages (their plain
versions here; the CUDA kernels are held against these on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``), the front chain's
branches, and the step dispatch around them.

Inputs are made with numpy from a seed and handed to both sides; the JAX
package's (σ, 2/σ²) is fed to the port. Its Pallas kernels run in
interpret mode, as its own tests run them. Every comparison is exact: the
inputs are integers, or the same float32 normals.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ops.pallas.step_kernel import (_snr_params,
                                              make_pallas_decode_count,
                                              make_pallas_front,
                                              make_pallas_front_blocks)
from polar_tpu_torch import ber
from polar_tpu_torch.decode import auto as decode_auto
from polar_tpu_torch.ops.cuda import front_kernel, step_kernel
from polar_tpu_torch.ops.transform import polar_transform_stages


def _jax_params(snr_db):
    return tuple(float(x) for x in np.asarray(_snr_params(snr_db)))


def _inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    msg = (1 - 2 * rng.integers(0, 2, (n, batch))).astype(np.int8)
    return msg, rng.standard_normal((n, batch), np.float32)


def _counts(d):
    return [int(d[k]) for k in step_kernel.COUNTERS]


@pytest.mark.parametrize("snr", [-1.0, 0.5])
@pytest.mark.parametrize("m", [6, 8, 9])
def test_front_plain_matches_pallas_front(m, snr):
    jc = jpt.make_code(m, rate=0.5)
    msg, nrm = _inputs(jc.N, 256, m)
    jfront = make_pallas_front(jc, frame_tile=128, interpret=True, prng="inject")
    want = jax.jit(jfront, static_argnums=2)(jnp.asarray(msg), jnp.asarray(nrm), snr)
    got = step_kernel.front(pt.code_from_jax(jc).frozen, _jax_params(snr),
                            msg_t=torch.from_numpy(msg),
                            normals_t=torch.from_numpy(nrm))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((got[0] == 0).sum()) > 0


@pytest.mark.parametrize("m", [6, 8])
def test_decode_count_plain_matches_pallas_decode_count(m):
    """Full-range int8 LLRs (−128, zeros and saturation included) and a
    systematic codeword batch."""
    jc = jpt.make_code(m, rate=0.5)
    rng = np.random.default_rng(17 + m)
    batch = 256
    llr = rng.integers(-128, 128, (jc.N, batch)).astype(np.int8)
    llr[0, :] = -128
    msg = (1 - 2 * rng.integers(0, 2, (batch, jc.K))).astype(np.int8)
    cw = np.asarray(jpt.encode_systematic(jc, jnp.asarray(msg))).T.copy()
    code = pt.code_from_jax(jc)
    got = step_kernel.decode_count(pt.compile_program(code), code.frozen,
                                   torch.from_numpy(llr), torch.from_numpy(cw))
    for wide in (False, True):
        count = make_pallas_decode_count(jc, frame_tile=128, interpret=True,
                                         wide=wide)
        assert got.tolist() == _counts(count(jnp.asarray(llr), jnp.asarray(cw)))
    assert 0 < int(got[1]) <= batch and int(got[4]) > 0


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("bl,cbl", [(6, 6), (6, 5), (4, 7)])
def test_kernel_middle_front_matches_pallas_front_blocks(bl, cbl, systematic):
    """``middle_mode="kernel"`` (its plain version here) against the JAX
    block front with its ``_stages_kernel`` middle: the middle alone on
    kernel A's output, and the whole front."""
    jc = jpt.make_code(9, rate=0.5)
    code = pt.code_from_jax(jc)
    msg, nrm = _inputs(jc.N, 128, bl * 10 + cbl)
    snr = -1.0
    kw = dict(frame_tile=128, block_level=bl, chan_block_level=cbl,
              interpret=True, systematic=systematic, middle_mode="kernel")
    jfront = make_pallas_front_blocks(jc, prng="inject", **kw)
    want = jax.jit(jfront, static_argnums=2)(jnp.asarray(msg), jnp.asarray(nrm), snr)
    got = front_kernel.front_blocks(
        code.frozen, _jax_params(snr), systematic, msg_t=torch.from_numpy(msg),
        normals_t=torch.from_numpy(nrm), block_level=bl, chan_block_level=cbl,
        middle_mode="kernel")
    assert len(got) == len(want) == (2 if systematic else 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the middle alone: the native front's middle takes no random words
    x = front_kernel.msg_blocks_plain(code.frozen, 1 << bl, systematic,
                                      msg_t=torch.from_numpy(msg))
    jmid = make_pallas_front_blocks(jc, prng="native", **kw).middle
    mid = front_kernel.middle_plain(x, code.frozen, 1 << bl, 1 << cbl, systematic)
    np.testing.assert_array_equal(mid.numpy(), np.asarray(jmid(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("max_log", [1, 3, 8])
def test_middle_pass_plan_covers_every_stage(max_log):
    """The middle kernel's passes, applied as torch stages, are the plain
    middle at every block pair, both modes."""
    c = pt.make_code(7, rate=0.5)
    n = c.N
    x = torch.from_numpy(_inputs(n, 8, max_log)[0])
    frz = torch.from_numpy(c.frozen.astype(bool)).reshape(n, 1)
    for la in range(8):
        for lb in range(8):
            for systematic in (True, False):
                want = front_kernel.middle_plain(x, c.frozen, 1 << la, 1 << lb,
                                                 systematic)
                y = x
                for lo, glog, s1, refreeze, s2 in front_kernel.middle_passes(
                        n, 1 << la, 1 << lb, systematic, max_log):
                    assert 0 < glog <= max_log or (glog == 0 and refreeze)
                    y = polar_transform_stages(y, 1 << (lo + s1[0]),
                                               1 << (lo + s1[1]), axis=0)
                    if refreeze:
                        assert lo + glog == 7
                        y = torch.where(frz, torch.ones_like(y), y)
                    y = polar_transform_stages(y, 1 << (lo + s2[0]),
                                               1 << (lo + s2[1]), axis=0)
                assert torch.equal(y, want), (la, lb, systematic)


def _jax_whole_count_chain(jc):
    front = make_pallas_front(jc, frame_tile=128, interpret=True, prng="inject")
    count = make_pallas_decode_count(jc, frame_tile=128, interpret=True)
    return jax.jit(lambda m, n, snr: count(*front(m, n, snr)))


@pytest.mark.parametrize("m", [7, 9])
def test_front_chain_inject_matches_pallas_whole_front_chain(m):
    """The port's front chain on injected inputs counts what JAX's
    ``make_pallas_front`` → ``make_pallas_decode_count`` counts; at m = 9
    the block-front branches too, by name: block + the interpreter's
    decode+count (the default from m = 13) and block + whole-code decoder
    + counter kernel (JAX's by moving its threshold, as
    ``tests/test_step_kernel.py`` does)."""
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    jchain = _jax_whole_count_chain(jc)
    inputs = [(snr, *_inputs(jc.N, 128, 100 * m + i))
              for i, snr in enumerate((-1.0, 1.5))]
    wants = [_counts(jchain(jnp.asarray(msg), jnp.asarray(nrm), jnp.float32(snr)))
             for snr, msg, nrm in inputs]
    assert wants[0][0] > 0
    assert ber.front_branch(code, True) == (
        "whole" if m <= ber.FRONT_WHOLE_MAX_LEVEL else "block-whole")
    branches = [None]                      # the default: whole
    if m == 9:
        branches += ["block-whole", "block-interp"]
    for branch in branches:
        chain = ber.make_front_chain(code, systematic=True, branch=branch)
        for (snr, msg, nrm), want in zip(inputs, wants):
            got = chain(_jax_params(snr), msg_t=torch.from_numpy(msg),
                        normals_t=torch.from_numpy(nrm))
            assert got.tolist() == want, (branch, snr)


def test_front_branch_follows_the_thresholds(monkeypatch):
    for m, sys_branch, plain_branch in ((8, "whole", "block-whole"),
                                        (9, "whole", "block-whole"),
                                        (11, "whole", "block-whole"),
                                        (12, "block-whole", "block-whole"),
                                        (13, "block-interp", "block-whole"),
                                        (14, "block-interp", "block-hybrid"),
                                        (17, "block-interp", "block-hybrid"),
                                        (18, "block-hybrid", "block-hybrid")):
        c = pt.make_code(m, rate=0.5)
        assert ber.front_branch(c, True) == sys_branch
        assert ber.front_branch(c, False) == plain_branch
    # one owner for the decoder: the front follows decode.auto's threshold,
    # and takes the interpreter where its table names it at every batch
    assert decode_auto.HYBRID_MIN_LEVEL == 14 and ber.FRONT_WHOLE_MAX_LEVEL == 11
    for names, want in ((("interp", "hybrid"), "block-hybrid"),
                        (("hybrid", "interp"), "block-hybrid"),
                        (("interp", "interp"), "block-interp")):
        monkeypatch.setitem(decode_auto.AUTO_DECODERS, (14, True), names)
        assert ber.front_branch(pt.make_code(14, rate=0.5), True) == want
    c = pt.make_code(9, rate=0.5)
    monkeypatch.setattr(decode_auto, "HYBRID_MIN_LEVEL", 9)
    monkeypatch.setattr(ber, "FRONT_WHOLE_MAX_LEVEL", 8)
    assert ber.front_branch(c, True) == ber.front_branch(c, False) == "block-hybrid"
    monkeypatch.setattr(ber, "FRONT_WHOLE_MAX_LEVEL", 9)
    assert ber.front_branch(c, True) == "whole"
    with pytest.raises(ValueError, match="branch"):
        ber.make_front_chain(c, systematic=False, branch="whole")
    with pytest.raises(ValueError, match="branch"):
        ber.make_front_chain(c, branch="hybrid")
    with pytest.raises(ValueError, match="kernel_level"):
        ber.make_front_chain(c, branch="whole", kernel_level=5)
    with pytest.raises(ValueError, match="middle_mode"):
        front_kernel.front_blocks(c.frozen, (1.0, 2.0), True, batch=4,
                                  device="cpu", middle_mode="xla")


def test_front_decode_cfg_rejected_off_the_hybrid_branch(monkeypatch):
    c = pt.make_code(9, rate=0.5)
    monkeypatch.setattr(ber, "AUTO_STEP_PATH", {})          # the front path
    for whole in (9, 8):                                    # whole, cw whole
        monkeypatch.setattr(ber, "FRONT_WHOLE_MAX_LEVEL", whole)
        with pytest.raises(ValueError, match="front_decode_cfg"):
            ber.make_step(c, front_decode_cfg=5, device="cpu")
    monkeypatch.setattr(decode_auto, "HYBRID_MIN_LEVEL", 9)
    step = ber.make_step(c, front_decode_cfg=5, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    assert set(step(gen, 0.0, 16)) == set(step_kernel.COUNTERS)


def test_step_paths_by_level_table(monkeypatch):
    """``AUTO_STEP_PATH`` picks the step for codes without a pinned
    decoder; every path counts what the fused step counts on the same
    seeds (the front path draws its words, the draws path does not)."""
    c = pt.make_code(8, rate=0.5)
    path = lambda dev, batch=4096: ber._step_path(  # noqa: E731
        c, torch.int8, None, None, "auto", dev, batch=batch)
    big = ber.AUTO_BIG_BATCH
    for want in ("fused", "front", "draws"):
        monkeypatch.setattr(ber, "AUTO_STEP_PATH", {(8, True): (want, "front")})
        assert path("cuda") == path("cuda", big - 1) == want
        assert path("cuda", big) == "front"
        assert ber._step_path(c, torch.int8, None, None, "auto", "cuda",
                              systematic=False) == "front"   # not listed
    assert path("cpu") == "plain"
    fused = ber.make_step(c, fused=True, device="cpu")
    # a step takes each batch's path: the fused step below AUTO_BIG_BATCH,
    # the torch draws (the draws' CPU stand-in) from it
    monkeypatch.setattr(ber, "AUTO_STEP_PATH", {(8, True): ("fused", "draws")})
    auto = ber.make_step(c, device="cpu")
    before = dict(step_kernel.plain_calls)
    assert set(auto(torch.Generator().manual_seed(0), 0.0, 16)) == set(
        step_kernel.COUNTERS)
    assert step_kernel.plain_calls["step_plain"] == before["step_plain"] + 1
    monkeypatch.setattr(ber, "AUTO_BIG_BATCH", 32)
    auto(torch.Generator().manual_seed(0), 0.0, 32)
    assert step_kernel.plain_calls["step_plain"] == before["step_plain"] + 1
    monkeypatch.setattr(ber, "AUTO_STEP_PATH", {(8, True): ("fused", "fused")})
    monkeypatch.setattr(ber, "STEP_KERNEL_MAX_LEVEL", 7)
    assert path("cpu") == "front"
    body = ber.make_step_body(c, rng="kernel", device="cpu")  # the front path
    before = dict(step_kernel.plain_calls)
    for seed, snr in ((1, -1.5), (2, 1.0)):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        a = {k: int(v) for k, v in body(g1, snr, 96).items()}
        assert a == {k: int(v) for k, v in fused(g2, snr, 96).items()}
    assert step_kernel.plain_calls["front_plain"] > before["front_plain"]
    with pytest.raises(ValueError, match="words="):
        body(g1, 0.0, 8, words=(None, None, None))
