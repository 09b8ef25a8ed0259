"""The interpreter tile kernel's schedule (``interp_kernel.schedule``) on
the CPU.

The tile kernel (``csrc/interp.cu`` ``interp_tile_kernel``) runs a
program as grid entries (the words at or above the grid level G, over the
whole batch) and tile runs (each maximal run of words below G, one warp's
tile of 8 frames at a time). A CUDA kernel has no CPU mode, so these tests
hold what the host decides against the reference: (a) the split covers
every word once, in order, each tile run the words of one subtree rooted
below G and the grid steps exactly the words at or above G (G is at least
kl + 1: a body that is not a leaf is never a grid step); (b) the schedule
run in the kernel's order in torch by this module's ``schedule_twin``
(grid entries over the whole batch, each tile run on each tile alone,
device arrays starting as random bytes) equals ``interp_plain`` and the
JAX package's decoders bit for bit on tie-heavy LLRs; (c) each body's
compacted message rows are its info positions. Inputs are made with
numpy from a seed.
"""

import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import polar_tpu as jpt
import polar_tpu_torch as pt
from polar_tpu.decode.fastssc import make_fastssc_decoder as j_fastssc
from polar_tpu.ops.pallas.interp_kernel import (make_interp_decode_count,
                                                make_interp_decoder,
                                                make_interp_subtree)
from polar_tpu_torch.code.compiler import build_tree, node_frozen
from polar_tpu_torch.decode.fastssc import _TreeDecoder
from polar_tpu_torch.ops.arith import Int8Arith
from polar_tpu_torch.ops.cuda import interp_kernel as ik
from polar_tpu_torch.ops.cuda import step_kernel
from polar_tpu_torch.ops.transform import polar_transform

VEC = Path(__file__).resolve().parent / "vectors" / "golden.npz"
TRACKS = {"u": (False, True), "codeword": (True, False), "both": (True, True)}


def _golden_codes():
    with np.load(VEC) as z:
        return {k: pt.PolarCode(int(k.split("_")[1]), z[k].astype(np.uint8))
                for k in sorted(z) if k.startswith("mask_")}


GOLDEN = _golden_codes()


def _ties(n, batch, seed):
    """Element-major (N, B) int8: full range, a third of it zeros and
    edge values (ties for the sign, the minimum and the fold)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, batch))
    edge = rng.random((n, batch)) < 0.35
    x[edge] = rng.choice(np.array([-128, -127, -1, 0, 0, 1, 127]),
                         int(edge.sum()))
    return x.astype(np.int8)


def _nodes(tree):
    """{(position, level): node} of every node of the tree."""
    out, stack = {}, [(tree, 0)]
    while stack:
        node, pos = stack.pop()
        out[pos, node.level] = node
        half = 1 << (node.level - 1)
        for child, p in ((node.left, pos), (node.right, pos + half)):
            if child is not None:
                stack.append((child, p))
    return out


# -- a torch twin of the tile kernel's order ------------------------------


def _spc_key(x):
    """int16 keys of int8 values: bits 0-6 qabs (-128 -> 127), bit 7 the
    sign (csrc/interp.cu spc_key)."""
    x = x.to(torch.int16)
    return torch.minimum(x.abs(), torch.tensor(127, dtype=torch.int16)) | (
        (x < 0).to(torch.int16) << 7)


def _key_comb(a, b):
    """The least qabs and the parity of two keys (``key_comb``)."""
    return torch.minimum(a & 0x7F, b & 0x7F) | ((a ^ b) & 0x80)


def schedule_twin(c, sched, llr_t, *, want_cw: bool,
                  want_u: bool, prefill: bool, seed: int = 0):
    """Run ``sched`` in the tile kernel's order in torch on the CPU:
    ``(hard, cw, u)``, u compacted (K rows). The device arrays start as
    random bytes, as ``torch.empty`` leaves them; a grid entry acts on the
    whole batch, a tile run on each ``ik.TILE_FRAMES``-frame tile alone,
    with its own on-chip rows (soft pyramid, hard, cw) and its root slot
    read in the device pyramid; the bodies are the eager recursion."""
    ph = Int8Arith()
    n, b = 1 << c.level, llr_t.shape[1]
    gen = torch.Generator().manual_seed(seed)
    k = int(np.count_nonzero(np.asarray(c.mask) == 0))

    def junk(rows):
        return torch.randint(-128, 128, (rows, b), generator=gen,
                             dtype=torch.int8)

    arrays = [llr_t, junk(n + 1), junk(n), junk(n) if want_cw else None,
              junk(k) if want_u else None]

    def rows(v, count):
        a, r = arrays[v >> ik.ROW_BITS], v & ((1 << ik.ROW_BITS) - 1)
        return a[r:r + count]

    def put(v, x):
        a, r = arrays[v >> ik.ROW_BITS], v & ((1 << ik.ROW_BITS) - 1)
        a[r:r + x.shape[0]] = x

    for kind, cnt, ra, rb, rc, rd, re, x in sched.entries.tolist():
        kind &= 0xFF
        if kind == ik.RUN:
            _twin_run(c, arrays, ra, rb, rc, rd, sched.mrows, want_cw,
                      want_u, prefill)
        elif kind == ik.S_F:
            put(rd, ph.prod(rows(ra, cnt), rows(rb, cnt)))
        elif kind == ik.S_G:
            put(rd, ph.madd(rows(rc, cnt), rows(ra, cnt), rows(rb, cnt)))
        elif kind == ik.S_ADD:
            put(rd, ph.qadd(rows(ra, cnt), rows(rb, cnt)))
        elif kind == ik.S_HMUL:
            put(rd, rows(ra, cnt) * rows(rb, cnt))
        elif kind == ik.S_COPY:
            put(rd, rows(ra, cnt).clone())
        elif kind == ik.S_GRATE1:
            hl = rows(rc, cnt).clone()
            hr = ph.signum(ph.madd(hl, rows(ra, cnt), rows(rb, cnt)))
            if re >= 0:
                put(rc, hl * hr)
                put(re, hr)
            put(rd, hr)
        elif kind == ik.S_STAGE:
            hs = 1 << x
            src = rows(ra, 2 * cnt).clone().view(-1, 2, hs, b)
            lo, hi = src[:, 0] * src[:, 1], src[:, 1]
            put(rd, torch.stack([lo, hi], 1).reshape(2 * cnt, b))
        elif kind == ik.S_RATE1:
            h = ph.signum(rows(ra, cnt))
            if rc >= 0:
                put(rc, h)
            put(rd, h)
        elif kind in (ik.S_KEY, ik.S_KEYRED):
            a, bb = rows(ra, cnt), rows(rb, cnt)
            if kind == ik.S_KEY:
                a, bb = _spc_key(a), _spc_key(bb)
            else:
                a, bb = a.to(torch.int16) & 0xFF, bb.to(torch.int16) & 0xFF
            put(rd, _key_comb(a, bb).to(torch.uint8).view(torch.int8))
        elif kind == ik.S_FLIP:
            key = rows(rb, 1).to(torch.int16) & 0xFF
            xs = rows(ra, cnt)
            flip = ((_spc_key(xs) & 0x7F) == (key & 0x7F)) & (key >= 0x80)
            h = torch.where(xs < 0, -1, 1).to(torch.int8)
            h = torch.where(flip, -h, h)
            if rc >= 0:
                put(rc, h)
            put(rd, h)
        elif kind == ik.S_REPBC:
            bit = ph.signum(rows(rb, 1)).expand(cnt, b)
            for v in (rc, rd):
                if v >= 0:
                    put(v, bit.clone())
            if re >= 0:
                put(re, bit[:1].clone())
        elif kind == ik.S_FILL:
            put(rd, torch.ones((cnt, b), dtype=torch.int8))
        else:  # pragma: no cover
            raise AssertionError(kind)
    return arrays[ik.HARD], arrays[ik.CW], arrays[ik.U]


def _twin_run(c, arrays, start, end, r, p0, mrows, want_cw, want_u,
              prefill):
    """One tile run, tile by tile (:func:`schedule_twin`)."""
    ph = Int8Arith()
    n_r, b = 1 << r, arrays[ik.IN].shape[1]
    root = (arrays[ik.IN] if r == c.level
            else arrays[ik.PYR][n_r:2 * n_r])
    for f0 in range(0, b, ik.TILE_FRAMES):
        fs = slice(f0, min(b, f0 + ik.TILE_FRAMES))
        w = fs.stop - f0
        soft = torch.zeros((n_r, w), dtype=torch.int8)
        fill = torch.ones if prefill else torch.zeros
        hard = fill((n_r, w), dtype=torch.int8)
        cw = fill((n_r, w), dtype=torch.int8) if want_cw else None

        def slot(lv):
            return root[:, fs] if lv == r else soft[1 << lv:2 << lv]

        for i in range(start, end):
            wd = int(c.words[i])
            kind, lv, _, need_hard, do_cw, do_u, p_off, m_off = (
                int(x) for x in c.desc[wd & 0xFFFF])
            q = (wd >> 16 << c.kl) - p0
            s = slot(lv)
            if kind == ik.BODY:
                ln = 1 << lv
                node = build_tree(c.table[m_off:m_off + ln], lv)
                dec = _TreeDecoder(ph, want_cw=want_cw, axis=0)
                h_b, cw_b = dec.decode(node, s)
                hard[q:q + ln] = h_b
                if want_cw:
                    cw[q:q + ln] = cw_b
                if want_u and dec.mesg:
                    mesg = torch.cat(dec.mesg, dim=0)
                    arrays[ik.U][mrows[i]:mrows[i] + mesg.shape[0], fs] = mesg
                continue
            h = 1 << (lv - 1)
            a, bb = s[:h], s[h:]
            if kind == ik.F:
                soft[h:2 * h] = ph.prod(a, bb)
            elif kind == ik.G:
                soft[h:2 * h] = ph.madd(hard[q:q + h], a, bb)
            elif kind == ik.G0:
                soft[h:2 * h] = ph.qadd(a, bb)
            elif kind in (ik.COMB, ik.COMB0):
                for on, x in ((need_hard, hard), (do_cw and want_cw, cw)):
                    if on:
                        x[q:q + h] = (x[q + h:q + 2 * h] if kind == ik.COMB0
                                      else x[q:q + h] * x[q + h:q + 2 * h])
            elif kind == ik.GRATE1:
                hl = hard[q:q + h].clone()
                hr = ph.signum(ph.madd(hl, a, bb))
                if need_hard:
                    hard[q:q + h] = hl * hr
                    hard[q + h:q + 2 * h] = hr
                t = polar_transform(hr, axis=0)
                if want_u:
                    arrays[ik.U][mrows[i]:mrows[i] + h, fs] = t
                if want_cw:
                    cwr = polar_transform(t, axis=0)
                    cw[q:q + h] = cw[q:q + h] * cwr
                    cw[q + h:q + 2 * h] = cwr
        arrays[ik.HARD][p0:p0 + n_r, fs] = hard
        if want_cw:
            arrays[ik.CW][p0:p0 + n_r, fs] = cw




def _compile(code, sl, output, grid_level, tree=None):
    want_cw, want_u = TRACKS[output]
    return ik._compile(tree or pt.compile_code(code), code.frozen, sl,
                       want_cw, want_u, prefill_all=want_u,
                       grid_level=grid_level)


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_schedule_covers_every_word_once_in_order(key):
    """(a) at sl 2..10 and G 6..12 on the golden codes, both tracks."""
    code = GOLDEN[key]
    tree = pt.compile_code(code)
    nodes = _nodes(tree)
    for sl in range(2, 11):
        for g in range(6, 13):
            c = _compile(code, sl, "both", g, tree)
            s = c.sched
            lv = c.desc[c.words & 0xFFFF, 1]
            pos = (c.words.astype(np.int64) >> 16) << c.kl
            g_eff = max(g, c.kl + 1)
            assert s.grid_level == g_eff
            order = []
            for e, o in zip(s.entries.tolist(), s.origin.tolist()):
                if e[0] & 0xFF == ik.RUN:
                    start, end, r, p0 = e[2:6]
                    assert order == [] or order[-1] < start
                    order += range(start, end)
                    assert (r, p0) == (lv[start], pos[start])
                    assert r < g_eff or (r == c.level and end - start
                                         == len(c.words))
                    inside = np.flatnonzero((lv <= r) & (pos >= p0)
                                            & (pos < p0 + (1 << r)))
                    assert inside.tolist() == list(range(start, end))
                    assert (p0, r) in nodes
                elif o >= 0 and (not order or order[-1] != o):
                    order.append(o)
            assert order == list(range(len(c.words))), (sl, g)
            assert s.grid_steps == np.flatnonzero(lv >= g_eff).tolist()
            assert s.cooperative == (c.level >= g_eff)


def _twin(c, llr, output):
    want_cw, want_u = TRACKS[output]
    return schedule_twin(c, c.sched, llr, want_cw=want_cw, want_u=want_u,
                         prefill=c.prefill)


def _plain(c, llr, output):
    want_cw, want_u = TRACKS[output]
    return ik.interp_plain(c.words, c.desc, c.table, c.level, c.kl, llr,
                           want_cw=want_cw, want_u=want_u, prefill=c.prefill)


@functools.lru_cache(maxsize=None)
def _jax_xla(m):
    """(LLRs (N, 31), u, cw) by JAX's XLA decoder of Polar(2^m, 2^(m-1))."""
    llr = _ties(1 << m, 31, m)
    u, cw = jax.jit(j_fastssc(jpt.make_code(m, rate=0.5), output="both",
                              output_dtype=jnp.int8).lane_major)(
                                  jnp.asarray(llr))
    return llr, np.asarray(u), np.asarray(cw)


@pytest.mark.parametrize("sl", [3, 5, 10])
@pytest.mark.parametrize("m", range(6, 13))
def test_twin_equals_plain_and_jax(m, sl):
    """(b) u, codeword and both at B = 31 (the last tile ragged), G = 11
    from m = 11 and m - 2 below (so that every program below sl m has
    grid steps), against interp_plain and, to m = 9 (above it XLA's
    compile takes tens of seconds; tests/test_torch_interp.py holds
    interp_plain against it at m = 10), JAX's XLA decoder."""
    code = pt.make_code(m, rate=0.5)
    if m <= 9:
        llr, ju, jcw = _jax_xla(m)
    else:
        llr, ju, jcw = _ties(code.N, 31, m), None, None
    x = torch.from_numpy(llr)
    info = torch.as_tensor(code.info_indices)
    tree = pt.compile_code(code)
    for output in TRACKS:
        c = _compile(code, sl, output, 11 if m >= 11 else m - 2, tree)
        assert c.sched.cooperative == (c.kl < m)
        _, cw, u = _twin(c, x, output)
        _, pcw, pu = _plain(c, x, output)
        if u is not None:
            assert torch.equal(u, pu[info]), output
            if ju is not None:
                np.testing.assert_array_equal(u.numpy(), ju)
        if cw is not None:
            assert torch.equal(cw, pcw), output
            if jcw is not None:
                np.testing.assert_array_equal(cw.numpy(), jcw)


def _mask_code():
    """Polar(256, .) whose tree holds rate-1 leaves under rate0_right
    nodes, REP and SPC leaves and rate1_comb nodes above level 4."""
    frozen = np.zeros(256, np.uint8)
    frozen[:64] = 1           # rate0_right at level 7: right child rate-1
    frozen[128:144] = 1       # rate0_right at level 5 inside the right half
    frozen[160:191] = 1       # a REP at level 5
    frozen[192] = 1           # an SPC at level 6
    return pt.PolarCode(8, frozen)


KIND_CASES = {   # code, sl, G: together they reach every entry kind
    "mask": (_mask_code(), 2, 4), "m9-r25": (pt.make_code(9, rate=0.25), 2, 4),
    "m8-r90": (pt.make_code(8, rate=0.9), 2, 4),
    "rate1": (pt.PolarCode(5, np.zeros(32, np.uint8)), 2, 4)}


@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_twin_equals_plain_in_grid_leaves(case):
    """(b) rate-1, REP and SPC leaves, grate1s and prefills at the grid
    level, at B = 31 and 17."""
    code, sl, g = KIND_CASES[case]
    tree = pt.compile_code(code)
    info = torch.as_tensor(code.info_indices)
    for batch in (31, 17):
        x = torch.from_numpy(_ties(code.N, batch, code.N + batch))
        for output in TRACKS:
            c = _compile(code, sl, output, g, tree)
            _, cw, u = _twin(c, x, output)
            _, pcw, pu = _plain(c, x, output)
            if u is not None:
                assert torch.equal(u, pu[info]), output
            if cw is not None:
                assert torch.equal(cw, pcw), output


def test_grid_leaf_cases_reach_every_entry_kind():
    seen = set()
    for code, sl, g in KIND_CASES.values():
        for output in TRACKS:
            c = _compile(code, sl, output, g)
            seen |= set((c.sched.entries[:, 0] & 0xFF).tolist())
    assert seen == set(range(14))


@pytest.mark.parametrize("m,kl", [(6, 3), (8, 4)])
def test_twin_equals_jax_interp_kernel(m, kl):
    """(b) against JAX's interpreter kernel in interpret mode, as
    tests/test_torch_interp.py runs it (B = 128), at grid level kl + 1."""
    jc = jpt.make_code(m, rate=0.5)
    code = pt.code_from_jax(jc)
    llr = _ties(jc.N, 128, m)
    info = torch.as_tensor(code.info_indices)
    for output in ("u", "both") if m == 6 else ("both",):
        jdec = make_interp_decoder(jc, subtree_level=kl, output=output,
                                   interpret=True)
        want = jdec.lane_major(jnp.asarray(llr))
        want = want if isinstance(want, tuple) else (want,)
        c = _compile(code, kl, output, kl + 1)
        assert c.sched.cooperative
        _, cw, u = _twin(c, torch.from_numpy(llr), output)
        got = (u,) if output == "u" else (u, cw)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(u, _plain(c, torch.from_numpy(llr), output)[2][info])


def test_twin_decode_count_equals_jax():
    """(b) decode+count: the twin's cw track, counted, against JAX's
    make_interp_decode_count in interpret mode on a noisy systematic
    pair."""
    jc = jpt.make_code(8, rate=0.5)
    code = pt.code_from_jax(jc)
    rng = np.random.default_rng(17)
    msg = (1 - 2 * rng.integers(0, 2, (128, jc.K))).astype(np.int8)
    cw = np.asarray(jpt.encode_systematic(jc, jnp.asarray(msg)), np.int8)
    llr = np.clip(cw.astype(np.int32) * 24 + rng.integers(-64, 65, (128, jc.N)),
                  -128, 127).astype(np.int8)
    llr_t, cw_t = llr.T.copy(), cw.T.copy()
    llr_t[::7] = 0
    want = make_interp_decode_count(jc, subtree_level=4, frame_tile=128,
                                    interpret=True)(jnp.asarray(llr_t),
                                                    jnp.asarray(cw_t))
    c = ik._compile(pt.compile_code(code), code.frozen, 4, True, False,
                    grid_level=5)
    assert c.sched.cooperative
    _, hat, _ = schedule_twin(c, c.sched, torch.from_numpy(llr_t),
                              want_cw=True, want_u=False, prefill=c.prefill)
    frz = torch.as_tensor(code.frozen.astype(bool)).reshape(-1, 1)
    got = step_kernel.cw_counts(frz, torch.from_numpy(llr_t),
                                torch.from_numpy(cw_t), hat)
    assert got.tolist() == [int(want[k]) for k in step_kernel.COUNTERS]
    assert int(got[0]) > 0


def test_twin_subtree_equals_jax():
    """(b) the subtree entry (root hard kept): the twin's hard, cw and u
    against JAX's make_interp_subtree in interpret mode, a level-7 branch
    node of Polar(512, 256) at kl 3, grid level 5."""
    jc = jpt.make_code(9, rate=0.5)
    jtree, tree = jpt.compile_code(jc), pt.compile_code(pt.code_from_jax(jc))
    pairs, stack = [], [(jtree, tree)]
    while stack:
        jn, n = stack.pop()
        if n.level == 7 and n.kind == "branch" and n.mesg_bits >= 1:
            pairs.append((jn, n))
        for a, b in ((jn.left, n.left), (jn.right, n.right)):
            if b is not None:
                stack.append((a, b))
    jnode, node = pairs[0]
    slot = _ties(1 << node.level, 128, 7)
    want = make_interp_subtree(jnode, interpret=True, emit_u=True,
                               emit_cw=True, layout="lane",
                               subtree_level=3)(jnp.asarray(slot))
    c = ik._compile(node, node_frozen(node), 3, True, True,
                    root_need_hard=True, grid_level=5)
    assert c.sched.cooperative
    hard, cw, u = schedule_twin(c, c.sched, torch.from_numpy(slot),
                                want_cw=True, want_u=True, prefill=c.prefill)
    for a, b in zip((u, hard, cw), want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("key", ["mask_6_25", "mask_9_75", "mask_12_50",
                                 "mask_14_50"])
def test_message_rows_are_the_info_positions(key):
    """(c) each body's (grate1's) compacted message rows hold its info
    positions, at sl 2..10 and G 6 and 11."""
    code = GOLDEN[key]
    tree = pt.compile_code(code)
    info = np.flatnonzero(code.frozen == 0)
    bodies = 0
    for sl in range(2, 11):
        for g in (6, 11):
            c = _compile(code, sl, "u", g, tree)
            got = np.full(code.K, -1)
            for i, w in enumerate(c.words.tolist()):
                kind, lv, *_, m_off = c.desc[w & 0xFFFF]
                p = (w >> 16) << c.kl
                if kind == ik.BODY:
                    node = build_tree(c.table[m_off:m_off + (1 << lv)], lv)
                    want = ik.info_positions(node, p)
                    bodies += 1
                elif kind == ik.GRATE1:
                    want = list(range(p + (1 << (lv - 1)), p + (1 << lv)))
                else:
                    continue
                row = int(c.sched.mrows[i])
                assert info[row:row + len(want)].tolist() == want
                got[row:row + len(want)] = want
            assert got.tolist() == info.tolist()
    assert bodies > 20


def _frames(c):
    """The u schedule's arrays of each grid entry's rows a..e (-1: none),
    and its entry kinds."""
    e = c.sched.entries
    grid = (e[:, 0] & 0xFF) != ik.RUN
    return (np.where(e[grid, 2:7] >= 0, e[grid, 2:7] >> ik.ROW_BITS, -1),
            e[grid, 0] & 0xFF)


@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_u_schedule_twin_equals_plain_in_grid_leaves(case):
    """(b) the u track's schedule (u left to the transforms' last stages)
    run by the twin equals interp_plain, at B = 31 and 17; its grid
    entries read the root only as rows a and b, write u only as rows d
    and e, and never read u, so that the kernel may hold the root and u
    frame-major."""
    code, sl, g = KIND_CASES[case]
    tree = pt.compile_code(code)
    info = torch.as_tensor(code.info_indices)
    c = _compile(code, sl, "u", g, tree)
    arrays, _ = _frames(c)
    assert not (arrays[:, 2:] == ik.IN).any()
    assert not (arrays[:, :3] == ik.U).any()
    for batch in (31, 17):
        x = torch.from_numpy(_ties(code.N, batch, 3 * code.N + batch))
        _, _, u = schedule_twin(c, c.sched, x, want_cw=False,
                                want_u=True, prefill=c.prefill)
        assert torch.equal(u, _plain(c, x, "u")[2][info]), batch


def _root_codes():
    """Polar(512, .) codes whose root is a REP or SPC leaf, a rate0_right
    or a rate1_comb node: with the rate-1 case of KIND_CASES, every way
    the grid reads the frame-major root (as tests/test_torch_cuda.py's
    frame-major grid entries)."""
    n, half = 512, pt.make_code(9, rate=0.5).frozen
    rep, spc = np.ones(n, np.uint8), np.zeros(n, np.uint8)
    rep[-1], spc[0] = 0, 1
    r0_right, r1_comb = half.copy(), half.copy()
    r0_right[:n // 2], r1_comb[n // 2:] = 1, 0
    return {k: pt.PolarCode(9, v) for k, v in (
        ("rep", rep), ("spc", spc), ("rate0_right", r0_right),
        ("rate1_comb", r1_comb))}


ROOT_CASES = _root_codes()


@pytest.mark.parametrize("root", sorted(ROOT_CASES))
def test_u_schedule_twin_equals_plain_at_the_root(root):
    """(b) the u schedule at grid level 4, where the root's own entries
    read the root LLRs, at B = 31."""
    code = ROOT_CASES[root]
    assert pt.compile_code(code).kind == root
    x = torch.from_numpy(_ties(code.N, 31, 5))
    c = _compile(code, 2, "u", 4)
    _, _, u = schedule_twin(c, c.sched, x, want_cw=False, want_u=True,
                            prefill=c.prefill)
    assert torch.equal(u, _plain(c, x, "u")[2][
        torch.as_tensor(code.info_indices)])


def test_u_schedule_cases_reach_every_frame_major_access():
    """The grid-leaf and root cases' u schedules read the root in f, g,
    add, grate1, rate-1, key and flip entries, and write u in copy, stage
    and rep-broadcast entries."""
    reads, writes = set(), set()
    cases = list(KIND_CASES.values()) + [(c, 2, 4) for c in ROOT_CASES.values()]
    for code, sl, g in cases:
        arrays, kinds = _frames(_compile(code, sl, "u", g))
        reads |= set(kinds[(arrays[:, :2] == ik.IN).any(1)].tolist())
        writes |= set(kinds[(arrays[:, 3:] == ik.U).any(1)].tolist())
    assert reads == {ik.S_F, ik.S_G, ik.S_ADD, ik.S_GRATE1, ik.S_RATE1,
                     ik.S_KEY, ik.S_FLIP}
    assert writes == {ik.S_COPY, ik.S_STAGE, ik.S_REPBC}
