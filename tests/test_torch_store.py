"""The port's code store (``polar_tpu_torch.code.store``) against the JAX
package's: the same ``.npz`` format both ways, the integrity check, and
the decoder cache."""

import numpy as np
import pytest
import torch

import polar_tpu as jpt
from polar_tpu.code import store as j_store
import polar_tpu_torch as pt
from polar_tpu_torch.code import store


@pytest.mark.parametrize("m,rate", [(2, 0.5), (8, 0.25), (10, 0.5),
                                    (12, 0.75)])
def test_files_load_across_the_packages(tmp_path, m, rate):
    jc = jpt.make_code(m, rate=rate)
    j_store.save_code(jc, tmp_path / "jax.npz")
    got = pt.load_code(tmp_path / "jax.npz")
    assert got == pt.code_from_jax(jc)
    pt.save_code(got, tmp_path / "torch.npz")
    back = j_store.load_code(tmp_path / "torch.npz")
    assert back == jc
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "torch.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def _rewrite(path, **changes):
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    fields.update(changes)
    np.savez_compressed(path, **fields)


def test_corruption_and_other_versions_are_refused(tmp_path):
    code = pt.make_code(8, rate=0.5)
    path = tmp_path / "code.npz"
    pt.save_code(code, path)
    with np.load(path) as z:
        program = z["program"].copy()
        frozen = z["frozen"].copy()
    program[1] ^= 1
    _rewrite(path, program=program)
    with pytest.raises(ValueError, match="corrupt"):
        pt.load_code(path)
    with pytest.raises(ValueError, match="corrupt"):   # the JAX package agrees
        j_store.load_code(path)
    pt.save_code(code, path)
    flipped = frozen.copy()
    i = int(np.flatnonzero(frozen == 0)[0])
    flipped[i] = 1
    _rewrite(path, frozen=flipped)
    with pytest.raises(ValueError, match="corrupt"):
        pt.load_code(path)
    pt.save_code(code, path)
    _rewrite(path, version=np.int64(2))
    with pytest.raises(ValueError, match="version 2"):
        pt.load_code(path)


def test_decoder_cache_returns_the_same_decoder():
    cache = store.DecoderCache()
    code = pt.make_code(6, rate=0.5)
    a = cache.get(code, output="u")
    assert cache.get(pt.make_code(6, rate=0.5), output="u") is a
    assert cache.get(code, output="codeword") is not a
    assert cache.get(code) is not a
    assert len(cache) == 3
    llrs = torch.from_numpy(np.random.default_rng(3).integers(
        -128, 128, (64, code.N)).astype(np.int8))
    want = pt.make_fastssc_decoder(code, output="u")(llrs)
    assert torch.equal(a(llrs), want)
    assert isinstance(store.decoders, store.DecoderCache)


def test_decoder_cache_takes_another_builder():
    built = []

    def builder(code, **opts):
        built.append(opts)
        return pt.make_auto_decoder(code, device="cpu", **opts)

    cache = store.DecoderCache(builder)
    code = pt.make_code(5, rate=0.5)
    first = cache.get(code, output="u")
    assert cache.get(code, output="u") is first
    assert built == [{"output": "u"}]
    assert first[1] == "eager"
