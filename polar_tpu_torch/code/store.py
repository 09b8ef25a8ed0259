"""Persist constructed codes and memoize built decoders.

The port of ``polar_tpu.code.store``. A saved code file pins the exact
frozen set (independent of later ranking changes) together with its
Fast-SSC byte program, in the JAX package's ``.npz`` format (version 1),
so that either package loads the other's files; loading checks the stored
program against the one the mask compiles to. :class:`DecoderCache` gives
one built decoder per (code, options), the run-time analog of the
reference compiling its program once (``testbench.cc:95-97``).
"""

from __future__ import annotations

import numpy as np

from .compiler import compile_program
from .construction import PolarCode

_FORMAT_VERSION = 1


def save_code(code: PolarCode, path) -> None:
    """Write the code spec and its Fast-SSC byte program to an .npz."""
    np.savez_compressed(
        path,
        version=np.int64(_FORMAT_VERSION),
        level=np.int64(code.level),
        frozen=np.asarray(code.frozen, dtype=np.uint8),
        program=compile_program(code),
    )


def load_code(path) -> PolarCode:
    """Read a code file; raises ``ValueError`` on another format version
    or a program that does not match the stored mask."""
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported code file version {int(z['version'])}")
        code = PolarCode(int(z["level"]), z["frozen"])
        if not np.array_equal(z["program"], compile_program(code)):
            raise ValueError(f"corrupt code file {path}: program/mask mismatch")
    return code


class DecoderCache:
    """Memoize built decoders per (code, options) key.

    ``get(code, **opts)`` returns the same callable for identical
    arguments, so each code and configuration is built (its program
    compiled, its tables put on the device) once per process. The default
    builder is :func:`polar_tpu_torch.decode.fastssc.make_fastssc_decoder`;
    ``DecoderCache(builder=...)`` takes another, e.g. ``make_auto_decoder``.
    """

    def __init__(self, builder=None):
        if builder is None:
            from ..decode.fastssc import make_fastssc_decoder

            builder = make_fastssc_decoder
        self._builder = builder
        self._cache: dict = {}

    def get(self, code: PolarCode, **opts):
        key = (code, tuple(sorted((k, repr(v)) for k, v in opts.items())))
        if key not in self._cache:
            self._cache[key] = self._builder(code, **opts)
        return self._cache[key]

    def __len__(self):
        return len(self._cache)


decoders = DecoderCache()
