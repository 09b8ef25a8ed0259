"""The CUDA library's C surface, read from the sources on the CPU.

Every ``polar_tpu_torch/csrc/*.cu`` file defines its ``extern "C"`` entries;
``ops/cuda/build.py:SIGNATURES`` binds them by name. For each source file:
its entries are the ones listed below, each one is bound in ``SIGNATURES``
or called by another source, every binding names an entry some source
defines, and every bound entry of the file is called by name from a
module of ``polar_tpu_torch`` that is not a test. So no kernel is left
without a caller and no binding without a kernel: a redesign that keeps
the kernel it replaced, or its C entry, fails here until the entry, its
binding and its caller go together (or are listed below).
"""

import re
from pathlib import Path

import pytest

from polar_tpu_torch.ops.cuda import build

PACKAGE = Path(build.__file__).resolve().parents[2]
SOURCES = sorted(build.CSRC_DIR.glob("*.cu"))

# the entries each source defines
ENTRIES = {
    "channel_grid.cu": {"polar_symbols_lines", "polar_awgn_lines"},
    "count.cu": {"polar_count_rows", "polar_count_frames",
                 "polar_count_frames_occupancy"},
    "decoder.cu": {"polar_decode", "polar_tile_decode",
                   "polar_tile_decode_frames", "polar_f32_decode_frames",
                   "polar_simd_selftest", "polar_tile_block_rows"},
    "device.cu": {"polar_set_device", "polar_get_device"},
    "encode.cu": {"polar_encode_bits"},
    "front.cu": {"polar_front_msg_rows", "polar_front_chan_rows",
                 "polar_front_rows", "polar_front_middle"},
    "interp.cu": {"polar_interp_tile", "polar_interp_tile_occupancy"},
    "ring.cu": {"polar_ring_shift", "polar_enable_peer"},
    "scratch.cu": {"polar_scratch_decode", "polar_scratch_decode_frames",
                   "polar_scratch_subtree"},
    "step.cu": {"polar_step", "polar_tile_step", "polar_front_whole",
                "polar_decode_count", "polar_decode_count_tile"},
    "subtree.cu": {"polar_subtree", "polar_tile_subtree"},
}

_ENTRY = re.compile(r'extern "C" int (\w+)\([^)]*\)\s*([;{])')


def _entries(text: str, ending: str) -> set:
    """The entries ``text`` defines (``ending`` "{") or declares (";")."""
    return {m.group(1) for m in _ENTRY.finditer(text) if m.group(2) == ending}


def _c_callers(name: str, source: Path) -> list:
    """The other sources that declare ``name`` and call it."""
    out = []
    for other in SOURCES:
        text = other.read_text()
        if other != source and name in _entries(text, ";"):
            body = _ENTRY.sub("", text)     # the declarations taken out
            if re.search(rf"\b{name}\(", body):
                out.append(other.name)
    return out


def _python_text() -> str:
    return "\n".join(p.read_text() for p in sorted(PACKAGE.rglob("*.py")))


@pytest.mark.parametrize("source", SOURCES, ids=lambda p: p.name)
def test_csrc_entries_are_bound_and_called(source):
    defined = _entries(source.read_text(), "{")
    assert defined == ENTRIES[source.name]
    for name in sorted(defined):
        assert name in build.SIGNATURES or _c_callers(name, source), (
            f"{source.name}: {name} is neither bound in build.SIGNATURES "
            "nor called by another source")
    everywhere = set().union(*(_entries(p.read_text(), "{")
                               for p in SOURCES))
    assert set(build.SIGNATURES) <= everywhere, (
        sorted(set(build.SIGNATURES) - everywhere))
    python = _python_text()
    for name in sorted(defined & set(build.SIGNATURES)):
        assert re.search(rf"\.{name}\(", python), (
            f"{source.name}: {name} is bound but no module of "
            "polar_tpu_torch calls it")
