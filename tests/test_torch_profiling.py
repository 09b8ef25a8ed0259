"""The port's profiling helpers (``polar_tpu_torch.utils.profiling``) on the
CPU: ``trace`` writes a Chrome trace that holds an ``annotate`` range and
the operations run inside it."""

import torch

import polar_tpu_torch as pt
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import step_kernel
from polar_tpu_torch.utils.profiling import (OWN_KERNEL, annotate,
                                             own_kernels, trace,
                                             trace_events)


def test_trace_holds_the_annotation_and_the_work(tmp_path):
    code = pt.make_code(5, rate=0.5)
    with trace(tmp_path / "t") as prof:
        with annotate("polar_point"):
            step_kernel.step(pt.compile_program(code), code.frozen,
                             snr_params(0.0), True, seeds=(1, 2), batch=64,
                             device="cpu")
    path = prof.trace_file
    assert path.parent == tmp_path / "t" and path.is_file()
    names = [e.get("name") for e in trace_events(path)]
    assert "polar_point" in names
    assert any(n and n.startswith("aten::") for n in names)
    assert own_kernels(path) == []     # no card: the plain version ran


def test_sessions_write_files_of_their_own(tmp_path):
    files = []
    for _ in range(2):
        with trace(tmp_path) as prof:
            torch.ones(4).sum()
        files.append(prof.trace_file)
    assert files[0] != files[1]
    assert sorted(tmp_path.iterdir()) == sorted(files)


def test_annotate_outside_a_session_is_a_no_op():
    with annotate("nothing recording"):
        assert int(torch.ones(3).sum()) == 3


def test_own_kernel_names():
    """The port's kernels sit in their files' anonymous namespaces, torch's
    in at::native, demangled or not."""
    for name in ("(anonymous namespace)::tile_step_kernel<true>(int)",
                 "void (anonymous namespace)::front_rows_kernel(int)",
                 "_ZN12_GLOBAL__N_116count_rows_kernelEv"):
        assert OWN_KERNEL.match(name)
    for name in ("void at::native::vectorized_elementwise_kernel<4>()",
                 "polar_point", "Memcpy HtoD"):
        assert not OWN_KERNEL.match(name)


# -- the recorder: spans and launch counters, on only while a profiler
# session runs

import types  # noqa: E402

import pytest  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from polar_tpu_torch.ops.cuda import (build, channel_kernel,  # noqa: E402
                                      count_kernel, decoder_kernel,
                                      encode_kernel, front_kernel,
                                      interp_kernel, ring_kernel,
                                      subtree_kernel)
from polar_tpu_torch.utils import profiling  # noqa: E402

MODULES = (decoder_kernel, step_kernel, subtree_kernel, front_kernel,
           count_kernel, interp_kernel, channel_kernel, encode_kernel,
           ring_kernel)
FAKE = torch.device("cuda", 1)
CODE = pt.make_code(6, rate=0.5)
N, K, B = CODE.N, CODE.K, 8


def _session():
    """A CPU-only profiler session: the recorder runs while it does."""
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return [s[0] for s in spans]


def _node(code):
    """A composite node that emits message bits."""
    stack = [pt.compile_code(code)]
    while stack:
        node = stack.pop()
        if node.kind in ("branch", "rate0_right", "rate1_comb") and \
                node.mesg_bits >= 1 and node.level < code.level:
            return node
        stack.extend(c for c in (node.left, node.right) if c is not None)
    raise AssertionError("no composite node")


class _Library:
    """A stand-in for the kernels' library: every C entry returns 0
    (success) and launches nothing; the occupancy queries answer one block
    an SM."""

    def __getattr__(self, name):
        def entry(*args):
            if name.endswith("_occupancy"):
                args[-1]._obj.value = 1
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Fake ``cuda:1`` tensors (shapes and devices, no storage) reach each
    wrapper's launching branch: ``build.stream`` and the library are
    stood in for, and the device tables' caches start empty."""
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(build, "load_library", _Library)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    for mod, cache in ((decoder_kernel, "_tables"), (encode_kernel, "_tables"),
                       (front_kernel, "_frozen_bits"),
                       (count_kernel, "_tickets"),
                       (count_kernel, "_frame_waves"),
                       (interp_kernel, "_occupancy")):
        monkeypatch.setattr(mod, cache, {})
    # the fake launches count on copies: other tests read the real counters
    for mod in MODULES:
        monkeypatch.setattr(mod, "launches", dict(mod.launches))
    monkeypatch.setattr(step_kernel, "earlier_launches",
                        dict(step_kernel.earlier_launches))
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield


def _i8(*shape):
    return torch.empty(shape, dtype=torch.int8, device=FAKE)


def _launch_calls():
    """Counter key → a call of the wrapper that counts one launch under it
    (``front_middle``: one a pass). Where a wrapper slices its fake
    outputs after the launch (which a CPU build of torch refuses for a
    fake ``cuda`` tensor), or launches two kernels, the call is the
    launching function inside it."""
    program = pt.compile_program(CODE)
    frozen = CODE.frozen
    params = (0.5, 8.0)
    node = _node(CODE)
    slot = lambda: _i8(1 << node.level, B)  # noqa: E731
    f32 = lambda: torch.empty((N, B), dtype=torch.float32, device=FAKE)  # noqa: E731
    i64 = lambda *s: torch.empty(s, dtype=torch.int64, device=FAKE)  # noqa: E731
    step = lambda **kw: step_kernel.step(  # noqa: E731
        program, frozen, params, True, msg_t=_i8(N, B), normals_t=f32(), **kw)
    return {
        "fastssc_decoder_cw": lambda: decoder_kernel.decode(
            program, frozen, _i8(N, B), True),
        "fastssc_decoder_u": lambda: decoder_kernel.decode(
            program, frozen, _i8(N, B), False),
        "walk_decoder_cw": lambda: decoder_kernel.decode(
            program, frozen, _i8(N, B), True, "walk"),
        "walk_decoder_u": lambda: decoder_kernel.decode(
            program, frozen, _i8(N, B), False, "walk"),
        "scratch_decoder": lambda: decoder_kernel.decode(
            program, frozen, _i8(N, B), False, "scratch"),
        "fastssc_decoder_u_frames": lambda: decoder_kernel.decode(
            program, frozen, _i8(B, N), False, layout="frames"),
        "scratch_decoder_frames": lambda: decoder_kernel.decode(
            program, frozen, _i8(B, N), False, "scratch", layout="frames"),
        "f32_decoder_frames": lambda: decoder_kernel.decode_f32(
            program, frozen, torch.empty((B, N), dtype=torch.float32,
                                         device=FAKE)),
        "mc_step": lambda: step(),
        "walk_step": lambda: step(style="walk"),
        "front_whole": lambda: step_kernel.front(
            frozen, params, msg_t=_i8(N, B), normals_t=f32()),
        "front_whole_thread": lambda: step_kernel.front(
            frozen, params, msg_t=_i8(N, B), normals_t=f32(),
            style="thread"),
        "decode_count": lambda: step_kernel.decode_count(
            program, frozen, _i8(N, B), _i8(N, B)),
        "decode_count_walk": lambda: step_kernel.decode_count(
            program, frozen, _i8(N, B), _i8(N, B), "walk"),
        "subtree_decoder": lambda: subtree_kernel.make_subtree_decoder(node)(
            slot()),
        "walk_subtree": lambda: subtree_kernel.make_subtree_decoder(
            node, style="walk")(slot()),
        "scratch_subtree": lambda: subtree_kernel.make_subtree_decoder(
            node, style="scratch")(slot()),
        "front_blocks_a": lambda: front_kernel.msg_blocks(
            frozen, 16, True, msg_t=_i8(N, B)),
        "front_blocks_b": lambda: front_kernel.chan_blocks(
            _i8(N, B), 16, params, normals_t=f32()),
        "front_middle": lambda: front_kernel.middle_kernel(
            _i8(N, B), frozen, 4, 4, True),
        "count": lambda: count_kernel.count(frozen, _i8(N, B), _i8(N, B),
                                            _i8(N, B)),
        "count_frames": lambda: count_kernel.count_frames(
            _i8(B, K), _i8(B, N), _i8(B, N), _i8(B, K)),
        "interp_decoder": lambda: interp_kernel.make_interp_decoder(
            CODE, subtree_level=3).lane_major(_i8(N, B)),
        "interp_decoder_frames": lambda: interp_kernel._run_tile(
            interp_kernel.make_interp_decoder(
                CODE, subtree_level=3).compiled, _i8(B, N), hard_out=False,
            what="interp_decoder_frames", frames=True),
        "interp_decode_count": lambda: interp_kernel._run_tile(
            interp_kernel.make_interp_decode_count(
                CODE, subtree_level=3).compiled, _i8(N, B), hard_out=False,
            what="interp_decode_count"),
        "interp_subtree": lambda: interp_kernel.make_interp_subtree(
            node, subtree_level=3)(slot()),
        "channel_symbols": lambda: channel_kernel.symbols(words=i64(B, K)),
        "channel_awgn": lambda: channel_kernel.awgn(
            _i8(B, N), params, words=(i64(B, N), i64(B, N))),
        "block_encoder": lambda: encode_kernel.make_encoder(CODE)(_i8(B, K)),
        "ring_shift": lambda: ring_kernel.ring_shift([_i8(4, B), _i8(4, B)],
                                                     1),
    }


def _counts():
    """Every wrapper's ``launches``, and step_kernel's counter of the
    kernels its tile kernels replaced (the walk and the thread front, run
    above the tile kernels' levels)."""
    counters = [(mod.__name__, mod.launches) for mod in MODULES]
    counters.append(("step_kernel.earlier", step_kernel.earlier_launches))
    return {(name, key): v for name, c in counters for key, v in c.items()}


def test_torch_every_counter_has_a_launching_call():
    """The calls above reach every key of every wrapper's counters."""
    assert set(_launch_calls()) == {key for _, key in _counts()}


@pytest.mark.parametrize("key", sorted(_launch_calls()))
def test_torch_a_counted_launch_records_one_kernel_span(fake_card, key):
    """Each wrapper call that counts launches under a key records one span
    ``kernel.<key>`` (``front_middle``: one over its passes), inside the
    enclosing span; with no session it counts the same and records
    nothing."""
    call = _launch_calls()[key]
    profiling.take_spans()
    before = _counts()
    call()
    assert profiling.take_spans() == ([], 0)
    with _session():
        before = _counts()
        with profiling.annotate("outer"):
            call()
        after = _counts()
    spans, dropped = profiling.take_spans()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert [k for _, k in moved] == [key]
    want = (len(front_kernel.middle_passes(N, 4, 4, True))
            if key == "front_middle" else 1)
    assert list(moved.values()) == [want]
    assert _names(spans) == ["outer", f"kernel.{key}"] and dropped == 0
    (_, a0, b0, p0), (_, a1, b1, p1) = spans
    assert p0 == -1 and p1 == 0 and a0 <= a1 <= b1 <= b0


def test_torch_annotate_off_is_one_shared_no_op():
    profiling.take_spans()
    assert profiling.annotate("a") is profiling.annotate("b")
    assert profiling.begin() is None
    counts = {"k": 0}
    with profiling.annotate("a"):
        profiling.launched(profiling.begin(), counts, "k")
    assert counts == {"k": 1}
    assert profiling.take_spans() == ([], 0)


def test_torch_run_point_records_its_spans_with_parents():
    code = pt.make_code(5, rate=0.5)
    step = pt.make_step(code, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    profiling.take_spans()
    with _session():
        pt.run_point(code, 0.0, gen=gen, step=step, batch=32, max_frames=64,
                     device="cpu")
    spans, dropped = profiling.take_spans()
    assert dropped == 0
    call = ["run_point.step", "step.seeds", "step.unpack", "run_point.pull"]
    assert _names(spans) == ["run_point"] + call + call
    parents = [p for *_, p in spans]
    assert parents == [-1, 0, 1, 1, 0, 0, 5, 5, 0]
    for name, a, b, p in spans:
        assert a <= b
        if p >= 0:
            assert spans[p][1] <= a and b <= spans[p][2], name


def test_torch_frame_major_decode_records_its_spans(monkeypatch):
    """The frame-major entry on CPU tensors: ``decode`` over the transpose
    in, the kernel's span and the transpose out. The element-major decode
    is a stand-in that counts a launch as the wrappers do and decodes by
    the plain version (a fake ``cuda`` tensor cannot be transposed by a
    CPU build of torch)."""

    def decode(program, frozen, llr_t, want_cw, style):
        start = profiling.begin()
        out = decoder_kernel.decode_plain(program, frozen, llr_t, want_cw)
        profiling.launched(start, decoder_kernel.launches,
                           "fastssc_decoder_u")
        return out

    monkeypatch.setattr(decoder_kernel, "decode", decode)
    dec = pt.make_kernel_decoder(CODE)
    llrs = torch.randint(-9, 9, (B, N), dtype=torch.int8)
    profiling.take_spans()
    with _session():
        out = dec(llrs)
    spans, _ = profiling.take_spans()
    assert _names(spans) == ["decode", "decode.transpose_in",
                             "kernel.fastssc_decoder_u",
                             "decode.transpose_out"]
    assert [p for *_, p in spans] == [-1, 0, 0, 0]
    assert [a for _, a, _, _ in spans] == sorted(a for _, a, _, _ in spans)
    assert torch.equal(out, dec(llrs))


def test_torch_the_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    counts = {"k": 0}
    profiling.take_spans()
    with _session():
        with profiling.annotate("a"):
            for _ in range(3):
                profiling.launched(profiling.begin(), counts, "k")
        with profiling.annotate("b"):
            pass
    spans, dropped = profiling.take_spans()
    assert _names(spans) == ["a", "kernel.k", "kernel.k"] and dropped == 2
    assert counts == {"k": 3}
    assert profiling.take_spans() == ([], 0)


def test_torch_a_span_open_across_take_spans_closes_in_its_buffer():
    profiling.take_spans()
    with _session():
        with profiling.annotate("outer"):
            early, _ = profiling.take_spans()
            with profiling.annotate("inner"):
                pass
    late, _ = profiling.take_spans()
    assert _names(early) == ["outer"] and early[0][2] == 0
    assert _names(late) == ["inner"] and late[0][3] == -1


def test_torch_trace_files_hold_the_program_spans(tmp_path):
    """Inside :func:`trace` a span is also a ``record_function`` range."""
    code = pt.make_code(5, rate=0.5)
    gen = torch.Generator()
    gen.manual_seed(4)
    profiling.take_spans()
    with trace(tmp_path) as prof:
        pt.run_point(code, 0.0, gen=gen, step=pt.make_step(code, device="cpu"),
                     batch=32, max_frames=32, device="cpu")
    names = {e.get("name") for e in trace_events(prof.trace_file)}
    assert {"run_point", "run_point.step", "run_point.pull",
            "step.seeds"} <= names
    assert "run_point" in _names(profiling.take_spans()[0])


@pytest.mark.parametrize("style,key", [
    ("ssa", "fastssc_decoder_u_frames"), ("scratch", "scratch_decoder_frames")])
def test_torch_frame_major_kernel_entry_records_no_copies(fake_card, style,
                                                          key):
    """On (fake) card tensors the kernel decoder's frame-major u entry
    hands the kernel (B, N) LLRs: ``decode`` over the kernel's span, one
    launch under the frame-major key, a (B, K) message."""
    dec = pt.make_kernel_decoder(CODE, style=style)
    profiling.take_spans()
    with _session():
        before = _counts()
        out = dec(_i8(B, N))
        after = _counts()
    spans, _ = profiling.take_spans()
    assert _names(spans) == ["decode", f"kernel.{key}"]
    assert [p for *_, p in spans] == [-1, 0]
    moved = {k[1]: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {key: 1}
    assert tuple(out.shape) == (B, K) and out.device == FAKE


def test_torch_frame_major_interp_entry_records_no_copies(fake_card):
    """On (fake) card tensors the interpreter's u entry hands the kernel
    (B, N) LLRs: ``decode`` over the kernel's span, one launch under
    ``interp_decoder_frames``, a (B, K) message."""
    dec = interp_kernel.make_interp_decoder(CODE, subtree_level=3)
    profiling.take_spans()
    with _session():
        before = _counts()
        out = dec(_i8(B, N))
        after = _counts()
    spans, _ = profiling.take_spans()
    assert _names(spans) == ["decode", "kernel.interp_decoder_frames"]
    assert [p for *_, p in spans] == [-1, 0]
    moved = {k[1]: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"interp_decoder_frames": 1}
    assert tuple(out.shape) == (B, K) and out.device == FAKE


def test_torch_interp_cw_outputs_keep_the_transposing_entry(fake_card,
                                                           monkeypatch):
    """On (fake) card tensors the interpreter's cw outputs still enter
    through ``fastssc.frame_major`` (the transposing entry, stood in for
    here: a CPU build of torch refuses to copy a fake card tensor), and the
    u output does not."""
    entered = []

    def transposing(lane_major, what):
        def decode(llrs):
            entered.append(tuple(llrs.shape))
            return "transposed"
        return decode

    monkeypatch.setattr(interp_kernel, "frame_major", transposing)
    for output in ("systematic", "codeword", "both"):
        before = _counts()
        dec = interp_kernel.make_interp_decoder(CODE, subtree_level=3,
                                                output=output)
        assert dec(_i8(B, N)) == "transposed", output
        assert _counts() == before
    assert entered == [(B, N)] * 3
    out = interp_kernel.make_interp_decoder(CODE, subtree_level=3)(_i8(B, N))
    assert tuple(out.shape) == (B, K) and len(entered) == 3


@pytest.mark.parametrize("entry", ["kernel", "interp", "hybrid"])
def test_torch_every_frame_major_entry_records_its_copies(entry):
    """The kernel, interpreter and hybrid decoders' frame-major entries
    (plain versions on CPU tensors) share the spans of the copies."""
    make = {
        "kernel": lambda: pt.make_kernel_decoder(CODE),
        "interp": lambda: interp_kernel.make_interp_decoder(
            CODE, subtree_level=3),
        "hybrid": lambda: pt.make_fastssc_decoder(CODE, kernel_level=4),
    }[entry]
    dec = make()
    llrs = torch.randint(-9, 9, (B, N), dtype=torch.int8)
    profiling.take_spans()
    with _session():
        dec(llrs)
    spans, _ = profiling.take_spans()
    assert _names(spans) == ["decode", "decode.transpose_in",
                             "decode.transpose_out"]
    with pytest.raises(ValueError, match="expects"):
        dec(llrs[0])


# -- the step's counter span and the steps counted by path

from polar_tpu_torch import ber  # noqa: E402


def _draws_step():
    """The kernel draws around the eager u decoder (plain versions here)."""
    return ber.make_step_body(
        CODE, systematic=False, rng="kernel", device="cpu",
        decoder=pt.make_fastssc_decoder(CODE, output="u",
                                        output_dtype=torch.int8))


def test_torch_step_count_is_recorded_only_under_a_session():
    step = _draws_step()
    gen = torch.Generator()
    gen.manual_seed(6)
    profiling.take_spans()
    off = step(gen, 0.0, B)
    assert profiling.take_spans() == ([], 0)
    with _session():
        on = step(gen, 0.0, B)
    spans, dropped = profiling.take_spans()
    assert _names(spans) == ["step.seeds", "step.seeds", "step.count",
                             "step.unpack"] and dropped == 0
    assert [p for *_, p in spans] == [-1, -1, -1, 2]
    assert set(on) == set(off) == set(step_kernel.COUNTERS)


@pytest.mark.parametrize("path", ber.STEP_PATHS)
def test_torch_steps_are_counted_by_path(path):
    """One count a step call, under the path that ran it: the draws and the
    torch draws around a pinned decoder, the front path and the fused step
    (their plain versions on the CPU)."""
    dec = pt.make_fastssc_decoder(CODE, output="systematic",
                                  output_dtype=torch.int8)
    step = {
        "draws": _draws_step,
        "plain": lambda: pt.make_step(CODE, decoder=dec, device="cpu"),
        "front": lambda: ber.make_step_body(CODE, rng="kernel",
                                            device="cpu"),
        "fused": lambda: pt.make_step(CODE, device="cpu"),
    }[path]()
    gen = torch.Generator()
    gen.manual_seed(7)
    before = dict(ber.steps_by_path)
    step(gen, 0.5, B)
    ber.chain_steps(step)(gen, 0.5, B, 3)
    moved = {k: v - before[k] for k, v in ber.steps_by_path.items()
             if v != before[k]}
    assert moved == {path: 4}
