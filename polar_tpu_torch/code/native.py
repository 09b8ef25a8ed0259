"""Native (C) code construction and Fast-SSC compilation.

The port of ``polar_tpu.code.native``. Construction and program
compilation are host-side, per-code work (the reference runs them once per
code too: ``testbench.cc:82-97``); the C extension makes them fast at very
large N (2^20 and up). Its source is the port's own copy,
``polar_tpu_torch/csrc/native/polar_native.c``, whose module is
``_polar_tpu_torch_native`` (never the JAX package's ``_polar_native``).

The extension is built at first use by the host C compiler against
Python's headers, into ``build/polar_tpu_torch/`` under the repository
root, named by a hash of the source, the flags and the interpreter's
extension suffix, as :mod:`polar_tpu_torch.ops.cuda.build` names the CUDA
library. The build writes a temporary file and renames it, so parallel
workers never load a half-written file; a process that finds the file for
its hash loads it.

There is no fallback: if the build fails, every function but
:func:`have_native` raises :class:`NativeBuildError`. The numpy
implementations are :mod:`polar_tpu_torch.code.construction` and
:mod:`polar_tpu_torch.code.compiler`; programs are byte-identical and
construction agrees to transcendental-library rounding (last-ulp exp/log1p
differences between numpy's SIMD kernels and glibc), with masks equal at
every tested design point (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import math
import os
import shlex
import shutil
import subprocess
import sysconfig
import tempfile
from pathlib import Path

import numpy as np

MODULE = "_polar_tpu_torch_native"
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "native" / "polar_native.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "polar_tpu_torch"
# ISO C11 keeps every floating-point product and sum rounded on its own
# (no contraction into fused multiply-adds), as numpy rounds them
CFLAGS = ("-O3", "-std=c11", "-ffp-contract=off", "-fPIC", "-shared")

_native = None


class NativeBuildError(RuntimeError):
    """No C compiler or Python headers, or the compiler refused the source."""


def compiler() -> list[str]:
    """The host C compiler: ``$CC``, else Python's own, else ``cc`` or
    ``gcc`` on PATH, as an argument list."""
    for cand in (os.environ.get("CC"), sysconfig.get_config_var("CC")):
        if cand:
            args = shlex.split(cand)
            if shutil.which(args[0]):
                return args
    for name in ("cc", "gcc"):
        if shutil.which(name):
            return [name]
    raise NativeBuildError("no C compiler found ($CC, Python's CC, cc, gcc): "
                           "the native extension is built from source")


def python_include() -> Path:
    """The directory holding ``Python.h``; raises if it is missing."""
    inc = Path(sysconfig.get_paths()["include"])
    if not (inc / "Python.h").is_file():
        raise NativeBuildError(f"Python.h not found in {inc}: the native "
                               "extension needs Python's headers")
    return inc


def library_path() -> Path:
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    h = hashlib.sha256(" ".join(CFLAGS).encode() + suffix.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"{MODULE}_{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the extension unless the file for its hash exists; returns
    its path."""
    out = library_path()
    if out.is_file():
        return out
    cmd = [*compiler(), *CFLAGS, f"-I{python_include()}", str(SOURCE)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=out.suffix)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, "-lm"], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"C compiler failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load():
    """Build (if needed) and import the extension, once per process."""
    global _native
    if _native is None:
        path = build()
        spec = importlib.util.spec_from_file_location(MODULE, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _native = module
    return _native


def have_native() -> bool:
    """Whether the extension builds and loads here."""
    try:
        load()
    except (NativeBuildError, OSError, ImportError):
        return False
    return True


def bhattacharyya_logpe(level: int, erasure_probability: float = math.exp(-1.0)):
    raw = load().bhatt_logpe(level, float(erasure_probability))
    return np.frombuffer(raw, dtype=np.float64)


def bhattacharyya_dual(level: int, erasure_probability: float = math.exp(-1.0)):
    """(log pe, log(1-pe)) arrays, the native twin of
    :func:`polar_tpu_torch.code.construction.bhattacharyya_dual`: the same
    update formulas and branch point, agreeing with numpy to
    transcendental-library rounding in each domain's authoritative zone."""
    both = np.frombuffer(load().bhatt_dual(level, float(erasure_probability)),
                         dtype=np.float64)
    n = 1 << level
    return both[:n], both[n:]


def frozen_mask_fixed_k(level: int, K: int,
                        erasure_probability: float = math.exp(-1.0)):
    raw = load().frozen_fixed_k(level, int(K), float(erasure_probability))
    return np.frombuffer(raw, dtype=np.uint8).copy()


def frozen_mask_threshold(level: int, erasure_probability: float = 0.5,
                          freezing_threshold: float = 0.5):
    raw = load().frozen_threshold(level, float(erasure_probability),
                                  float(freezing_threshold))
    return np.frombuffer(raw, dtype=np.uint8).copy()


def compile_program(frozen: np.ndarray, level: int) -> np.ndarray:
    raw = load().compile_program(
        np.ascontiguousarray(frozen, dtype=np.uint8).tobytes(), int(level))
    return np.frombuffer(raw, dtype=np.uint8).copy()
