"""The port's parallel layer against polar_tpu's, on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port's
mesh is 8 positions on the CPU (a mesh may repeat a device), where the
ring-shift kernel's wrapper runs its plain version. The same numpy inputs
go through both:

* the ring shift's plain version against ``np.roll`` and JAX's
  ``ring_shift`` in interpret mode;
* the sharded transform and encoder against JAX's at m = 6..10 over 2, 4
  and 8 shards;
* the element-sharded decoder against JAX's XLA local decoder at m = 10,
  rates 0.25 / 0.5 / 0.75, over both transports, with and without
  ``batch_split``, in qfloat-f32 and with u_full's frozen slots;
* its refusals, the mesh helpers, the frame-sharded step's counters
  against the unsharded step's, and ``run_sharded_point`` against JAX's
  ``run_point``.

The larger decodes (m = 12..14, the crafted mask, JAX's own sharded
decoder) are in ``test_torch_seqpar.py``; the processes and the dry run in
``test_torch_multihost.py``; the kernel itself in ``test_torch_cuda.py``.
"""

import math
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.ber import run_point as jax_run_point
from polar_tpu.parallel.rdma import ring_shift as jax_ring_shift
from polar_tpu.parallel.seqpar import element_mesh as jax_element_mesh
from polar_tpu.parallel.seqpar import make_sharded_encoder as jax_encoder
from polar_tpu_torch.ops.cuda import ring_kernel
from polar_tpu_torch.parallel import mesh as tmesh
from polar_tpu_torch.parallel.campaign import (device_seeds,
                                               global_llr_batch,
                                               make_sharded_step,
                                               run_sharded_point)
from polar_tpu_torch.parallel.rdma import transport
from polar_tpu_torch.parallel.seqpar import (element_mesh,
                                             make_sharded_encoder,
                                             make_sharded_transform)
from polar_tpu_torch.parallel.seqpar_decode import make_seqpar_decoder

REPO = Path(__file__).resolve().parent.parent
_JAX_LOCAL: dict = {}


def _llrs(n, b, seed):
    x = np.random.default_rng(seed).integers(-128, 128, (b, n)).astype(np.int8)
    x[0, :] = -128          # saturation edge
    x[1, :] = 0             # all-zero ties
    x[2, ::2] = 0
    return x


def _jax_local_u(m, rate, llr):
    """JAX's XLA local decoder (u, int8), jitted once per code."""
    key = (m, rate)
    if key not in _JAX_LOCAL:
        _JAX_LOCAL[key] = jax.jit(jpt.make_fastssc_decoder(
            jpt.make_code(m, rate=rate), output_dtype=jnp.int8))
    return np.asarray(_JAX_LOCAL[key](jnp.asarray(llr)))


@pytest.mark.parametrize("off,dtype,stacked", [(1, np.int8, False),
                                               (-2, np.float32, False),
                                               (4, np.int8, True),
                                               (-1, np.int8, True)])
def test_torch_ring_shift_plain_matches_roll_and_jax(off, dtype, stacked):
    shape = (2, 8, 4) if stacked else (8, 4)
    axis = 1 if stacked else 0
    x = np.arange(np.prod(shape)).astype(dtype).reshape(shape)
    want = np.roll(x, -off, axis=axis)

    jmesh = jax_element_mesh(jax.devices()[:8])
    name = jmesh.axis_names[0]
    spec = P(None, name, None) if stacked else P(name, None)

    @partial(jax.shard_map, mesh=jmesh, in_specs=spec, out_specs=spec)
    def run(v):
        return jax_ring_shift(v, off, name, interpret=True)

    np.testing.assert_array_equal(np.asarray(run(jnp.asarray(x))), want)

    blocks = list(torch.chunk(torch.from_numpy(x), 8, dim=axis))
    launches = dict(ring_kernel.launches)
    for shift in (ring_kernel.ring_shift, ring_kernel.ring_shift_plain,
                  transport("rdma"), transport("ppermute")):
        got = shift(blocks, off)
        assert all(g.data_ptr() != b.data_ptr() for g, b in zip(got, blocks))
        np.testing.assert_array_equal(torch.cat(got, dim=axis).numpy(), want)
    assert ring_kernel.launches == launches   # CPU blocks: the plain version


def test_torch_ring_shift_refuses_mixed_blocks():
    with pytest.raises(ValueError):
        ring_kernel.ring_shift([torch.zeros(2, 3), torch.zeros(2, 4)], 1)
    with pytest.raises(ValueError):
        ring_kernel.ring_shift([torch.zeros(2, 3),
                                torch.zeros(2, 3, dtype=torch.int8)], 1)
    with pytest.raises(ValueError):
        transport("carrier-pigeon")


@pytest.mark.parametrize("m", [6, 7, 8, 9, 10])
def test_torch_sharded_encoder_matches_jax(m):
    """Over 2, 4 and 8 shards: the sharded transform against JAX's
    transform, both sharded encoders against the local ones, which equal
    JAX's sharded encoder over one of the shard counts per level (JAX's
    own tests hold it equal over the others; the port's local encoders
    equal JAX's in ``test_torch_encode.py``)."""
    code = pt.make_code(m, rate=0.5)
    jcode = jpt.make_code(m, rate=0.5)
    rng = np.random.default_rng(m)
    msg = (1 - 2 * rng.integers(0, 2, (4, code.K))).astype(np.int8)
    x = (1 - 2 * rng.integers(0, 2, (3, code.N))).astype(np.int8)
    jax_n = (2, 4, 8)[m % 3]
    for n in (2, 4, 8):
        mesh = element_mesh(["cpu"] * n)
        blocks = tmesh.split(torch.from_numpy(x), mesh, dim=-1)
        got = torch.cat(make_sharded_transform(mesh)(blocks), dim=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jpt.polar_transform(jnp.asarray(x))))
        for systematic in (True, False):
            local = pt.encode_systematic if systematic else pt.encode
            want = local(code, torch.from_numpy(msg)).numpy()
            if n == jax_n:
                np.testing.assert_array_equal(np.asarray(jax.jit(jax_encoder(
                    jcode, jax_element_mesh(jax.devices()[:n]),
                    systematic=systematic))(jnp.asarray(msg))), want)
            enc = make_sharded_encoder(code, mesh, systematic=systematic)
            np.testing.assert_array_equal(enc(torch.from_numpy(msg)).numpy(),
                                          want, err_msg=f"n={n}")
            parts = enc.shards(torch.from_numpy(msg))
            assert len(parts) == n
            np.testing.assert_array_equal(torch.cat(parts, -1).numpy(), want)


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
def test_torch_seqpar_decoder_matches_jax_local_m10(rate):
    """Polar(1024, K) over 8 positions: both transports, redundant and
    batch_split, bit for bit against JAX's XLA local decoder."""
    code = pt.make_code(10, rate=rate)
    llr = _llrs(code.N, 16, int(rate * 100))
    want = _jax_local_u(10, rate, llr)
    mesh = element_mesh(["cpu"] * 8)
    for comm in ("ppermute", "rdma"):
        for split in (False, True):
            got = make_seqpar_decoder(code, mesh, output="u", comm=comm,
                                      batch_split=split)(torch.from_numpy(llr))
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{comm} split={split}")


def test_torch_seqpar_decoder_u_full_qfloat_and_shards():
    code = pt.make_code(10, rate=0.5)
    llr = _llrs(code.N, 16, 5)
    want = _jax_local_u(10, 0.5, llr)
    mesh = element_mesh(["cpu"] * 8)
    x = torch.from_numpy(llr)
    u_full = make_seqpar_decoder(code, mesh)(x).numpy()
    assert u_full.shape == (16, code.N)
    assert np.all(u_full[:, code.frozen.astype(bool)] == 1)
    np.testing.assert_array_equal(u_full[:, code.info_indices], want)
    q = make_seqpar_decoder(code, mesh, output="u", compute="qfloat-f32")(x)
    assert q.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().astype(np.int8), want)
    # the per-position entry: element-major blocks in, blocks out
    dec = make_seqpar_decoder(code, mesh, output="u")
    blocks = tmesh.split(x.t().contiguous(), mesh, dim=0)
    parts = dec.shards(blocks)
    assert len(parts) == 8
    np.testing.assert_array_equal(torch.cat(parts).t().numpy(), want)
    full_parts = make_seqpar_decoder(code, mesh).shards(blocks)
    assert [tuple(p.shape) for p in full_parts] == [(code.N // 8, 16)] * 8
    np.testing.assert_array_equal(
        dec.lane_major(x.t().contiguous()).t().numpy(), want)


def test_torch_seqpar_decoder_validates():
    mesh8 = element_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="shard size"):
        make_seqpar_decoder(pt.make_code(4, rate=0.5), mesh8)   # S = 2
    with pytest.raises(ValueError, match="power-of-two"):
        make_seqpar_decoder(pt.make_code(6, rate=0.5),
                            element_mesh(["cpu"] * 6))
    with pytest.raises(ValueError, match="output"):
        make_seqpar_decoder(pt.make_code(8, rate=0.5), mesh8, output="cw")
    with pytest.raises(ValueError, match="comm"):
        make_seqpar_decoder(pt.make_code(8, rate=0.5), mesh8,
                            comm="carrier-pigeon")
    dec = make_seqpar_decoder(pt.make_code(8, rate=0.5), mesh8)
    with pytest.raises(ValueError):
        dec.shards([torch.zeros(32, 4, dtype=torch.int8)] * 7)
    with pytest.raises(ValueError):
        make_sharded_encoder(pt.make_code(2, rate=0.5), mesh8)


def test_torch_meshes_and_helpers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.frame_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        element_mesh()
    mesh = tmesh.frame_mesh(["cpu", torch.device("cpu")] * 2)
    assert mesh.size == 4 and mesh.shape == {tmesh.BATCH_AXIS: 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    x = torch.arange(24).reshape(8, 3)
    parts = tmesh.shard_batch(x, mesh)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert torch.equal(tmesh.gather_batch(parts), x)
    assert all(r is x for r in tmesh.replicate(x, mesh))
    with pytest.raises(ValueError):
        tmesh.split(torch.zeros(6, 2), mesh)
    a = global_llr_batch(pt.make_code(5, rate=0.5), mesh, per_device_batch=3,
                         seed=1)
    b = global_llr_batch(pt.make_code(5, rate=0.5), mesh, per_device_batch=3,
                         seed=1)
    assert [tuple(p.shape) for p in a] == [(3, 32)] * 4
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert a[0].dtype == torch.int8 and int(torch.cat(a).min()) >= -128
    seeds = [g.initial_seed() for g in device_seeds(4, mesh)]
    assert len(set(seeds)) == 4
    assert seeds[2:] == [g.initial_seed()
                         for g in device_seeds(4, tmesh.frame_mesh(["cpu"] * 2),
                                               first=2)]


def test_torch_frame_sharded_step_sums_unsharded_steps():
    code = pt.make_code(6, rate=0.5)
    mesh = tmesh.frame_mesh(["cpu"] * 8)
    step, got_mesh = make_sharded_step(code, mesh)
    assert got_mesh is mesh
    sharded = {k: int(v) for k, v in step(device_seeds(3, mesh), 0.5,
                                          64).items()}
    body = pt.make_step(code, device="cpu")
    alone = dict.fromkeys(sharded, 0)
    for g in device_seeds(3, mesh):
        for k, v in body(g, 0.5, 64).items():
            alone[k] += int(v)
    assert sharded == alone
    assert sharded["uncorrected_errors"] > 0
    with pytest.raises(ValueError):
        step(device_seeds(3, mesh)[:7], 0.5, 64)


def test_torch_sharded_point_reproducible_and_matches_jax():
    code = pt.make_code(6, rate=0.5)
    mesh = tmesh.frame_mesh(["cpu"] * 8)
    kw = dict(mesh=mesh, per_device_batch=256, max_global_frames=1 << 14,
              target_bit_errors=10 ** 6)
    a = run_sharded_point(code, 1.0, seed=11, **kw)
    b = run_sharded_point(code, 1.0, seed=11, **kw)
    assert a == b and a["frames"] == 1 << 14
    ref = jax_run_point(jpt.make_code(6, rate=0.5), 1.0,
                        key=jax.random.PRNGKey(0), batch=1024,
                        max_frames=1 << 14)
    # BER within 4 sigma (var of the estimate <= BER / frames per frame),
    # FER within 4 pooled binomial sigma
    e1, n1, e2, n2 = a["uncorrected_errors"], a["frames"], ref.bit_errors, \
        ref.frames
    ber = (e1 + e2) / ((n1 + n2) * code.K)
    assert abs(e1 / (n1 * code.K) - e2 / (n2 * code.K)) <= \
        4 * math.sqrt(ber * (1 / n1 + 1 / n2))
    f1, f2 = a["frame_errors"], ref.fer * ref.frames
    p = (f1 + f2) / (n1 + n2)
    assert abs(f1 / n1 - f2 / n2) <= 4 * math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    assert a["uncorrected_errors"] > 0


def test_torch_parallel_imports_no_jax():
    mods = ", ".join(f"polar_tpu_torch.parallel.{m}" for m in (
        "mesh", "rdma", "seqpar", "seqpar_decode", "campaign", "multihost",
        "dryrun"))
    code = (f"import sys, {mods}; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'polar_tpu.')) or m == 'polar_tpu']; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
