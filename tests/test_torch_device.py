"""Every kernel wrapper launches on the device of its tensors.

The kernels' library links the CUDA runtime statically and keeps its own
current device, so each wrapper asks ``build.stream(device)`` to make its
tensors' device current right before its launch. Here, without a card,
the wrappers run on fake tensors of ``cuda:1`` (torch's FakeTensorMode:
shapes and devices without storage), and a stand-in for ``build.stream``
records the device each one asks for and stops it there. The card test of
the same repair is ``tests/test_torch_cuda.py::test_torch_launch_sets_the_library_device``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import polar_tpu_torch as pt
from polar_tpu_torch.ops.cuda import (build, channel_kernel, count_kernel,
                                      decoder_kernel, encode_kernel,
                                      front_kernel, interp_kernel, ring_kernel,
                                      step_kernel, subtree_kernel)

DEV = torch.device("cuda", 1)
CODE = pt.make_code(6, rate=0.5)
N, K, B = CODE.N, CODE.K, 8


class _Asked(Exception):
    pass


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


def _i8(*shape):
    return torch.empty(shape, dtype=torch.int8, device=DEV)


def _calls():
    program = pt.compile_program(CODE)
    frozen = CODE.frozen
    params = (0.5, 8.0)
    node = _node(CODE)
    slot = lambda: _i8(1 << node.level, B)  # noqa: E731
    f32 = lambda: torch.empty((N, B), dtype=torch.float32, device=DEV)  # noqa: E731
    i64 = lambda *s: torch.empty(s, dtype=torch.int64, device=DEV)  # noqa: E731
    return {   # launch counter: the call that reaches its kernel
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
                                         device=DEV)),
        "mc_step": lambda: step_kernel.step(program, frozen, params, True,
                                            msg_t=_i8(N, B), normals_t=f32()),
        "walk_step": lambda: step_kernel.step(program, frozen, params, True,
                                              msg_t=_i8(N, B),
                                              normals_t=f32(), style="walk"),
        "front_whole": lambda: step_kernel.front(frozen, params,
                                                 msg_t=_i8(N, B),
                                                 normals_t=f32()),
        "decode_count": lambda: step_kernel.decode_count(
            program, frozen, _i8(N, B), _i8(N, B)),
        "subtree_decoder": lambda: subtree_kernel.make_subtree_decoder(node)(
            slot()),
        "walk_subtree": lambda: subtree_kernel.make_subtree_decoder(
            node, style="walk")(slot()),
        "scratch_subtree": lambda: subtree_kernel.make_subtree_decoder(
            node, style="scratch")(slot()),
        "front_blocks_a": lambda: front_kernel.msg_blocks(frozen, 16, True,
                                                          msg_t=_i8(N, B)),
        "front_blocks_b": lambda: front_kernel.chan_blocks(
            _i8(N, B), 16, params, normals_t=f32()),
        "front_middle": lambda: front_kernel.middle_kernel(_i8(N, B), frozen,
                                                           8, 8, True),
        "count": lambda: count_kernel.count(frozen, _i8(N, B), _i8(N, B),
                                            _i8(N, B)),
        "count_frames": lambda: count_kernel.count_frames(
            _i8(B, K), _i8(B, N), _i8(B, N), _i8(B, K)),
        "interp_decoder": lambda: interp_kernel.make_interp_decoder(
            CODE, subtree_level=3).lane_major(_i8(N, B)),
        "interp_decoder_frames": lambda: interp_kernel.make_interp_decoder(
            CODE, subtree_level=3)(_i8(B, N)),
        "interp_decode_count": lambda: interp_kernel.make_interp_decode_count(
            CODE, subtree_level=3)(_i8(N, B), _i8(N, B)),
        "interp_subtree": lambda: interp_kernel.make_interp_subtree(
            node, subtree_level=3)(slot()),
        "channel_symbols": lambda: channel_kernel.symbols(words=i64(B, K)),
        "channel_awgn": lambda: channel_kernel.awgn(
            _i8(B, N), params, words=(i64(B, N), i64(B, N))),
        "block_encoder": lambda: encode_kernel.make_encoder(CODE)(_i8(B, K)),
        "ring_shift": lambda: ring_kernel.ring_shift([_i8(4, B), _i8(4, B)],
                                                     1),
    }


@pytest.mark.parametrize("name", sorted(_calls()))
def test_torch_wrapper_asks_for_its_tensors_device(monkeypatch, name):
    asked = []

    def stream(device):
        asked.append(device)
        raise _Asked

    monkeypatch.setattr(build, "stream", stream)
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail(
        f"{name}: the library was loaded before the device was set"))
    for mod in (decoder_kernel, front_kernel, encode_kernel):
        monkeypatch.setattr(mod, "_tables", {}, raising=False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        call = _calls()[name]
        with pytest.raises(_Asked):
            call()
    assert [(d.type, d.index) for d in asked] == [("cuda", 1)], name


def test_torch_stream_sets_the_device_before_the_stream(monkeypatch):
    """``build.stream`` hands the tensor's index to ``polar_set_device``
    and raises on the runtime's error."""
    seen = []

    class Lib:
        def polar_set_device(self, index):
            seen.append(index)
            return 101      # cudaErrorInvalidDevice

    monkeypatch.setattr(build, "load_library", Lib)
    with pytest.raises(RuntimeError, match="polar_set_device"):
        build.stream(torch.device("cuda", 3))
    assert seen == [3]
    # a device without an index is torch's current device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    with pytest.raises(RuntimeError, match="polar_set_device"):
        build.stream(torch.device("cuda"))
    assert seen == [3, 2]


def test_torch_every_launching_wrapper_is_covered():
    """The calls above reach every kernel that a wrapper counts."""
    names = {n for mod in (decoder_kernel, step_kernel, subtree_kernel,
                           front_kernel, count_kernel, interp_kernel,
                           channel_kernel, encode_kernel, ring_kernel)
             for n in mod.launches}
    assert set(_calls()) == names
