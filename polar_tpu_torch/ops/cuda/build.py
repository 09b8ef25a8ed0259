"""Build the CUDA kernels with nvcc and bind them with ctypes.

All ``polar_tpu_torch/csrc/*.cu`` sources compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Every source compiles to an object of its own, all nvcc processes started
together, and one more nvcc links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -fmad=false -c -o <name>.o <name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libpolar_tpu_torch_<hash>.so *.o

``-fmad=false`` keeps every float product and sum of the channel math
rounded on its own, as the plain torch chain rounds them. The library goes
to ``build/polar_tpu_torch/`` under the repository root, named by a hash of
the sources and the flags, and is built at first use: a process that finds
the library for its hash loads it, any other builds it. There is no
fallback: if nvcc is missing or the build fails, :func:`load_library`
raises. The library links the CUDA runtime statically, so it keeps its own
current device: a wrapper takes its launch stream from :func:`stream`,
which first makes its tensors' device current there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "polar_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
# C entry points and their argument types (see the .cu files)
SIGNATURES = {
    "polar_decode": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "polar_tile_decode": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "polar_simd_selftest": (_P, _P),
    "polar_tile_block_rows": (_I, _I, _I),
    "polar_step": (_P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _U, _U, _U,
                   _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "polar_subtree": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _P),
    "polar_tile_subtree": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                           _P),
    "polar_tile_step": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P, _U,
                        _U, _U, _P, _P, _P, _I, _I, _P),
    "polar_front_msg_rows": (_P, _I, _I, _I, _I, _P, _U, _U, _U, _P, _I,
                             _P),
    "polar_front_chan_rows": (_I, _I, _I, _F, _F, _P, _P, _U, _U, _U, _P,
                              _P, _I, _P),
    "polar_front_middle": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P),
    "polar_front_whole": (_P, _I, _I, _F, _F, _P, _P, _U, _U, _U, _P, _P,
                          _I, _P),
    "polar_decode_count": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P),
    "polar_front_rows": (_P, _I, _I, _F, _F, _P, _P, _U, _U, _U, _P, _P, _I,
                         _I, _P),
    "polar_decode_count_tile": (_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P),
    "polar_count_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                         _P),
    "polar_count_frames": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P, _P),
    "polar_count_frames_occupancy": (_I, _P),
    "polar_symbols_lines": (_I, _I, _P, _U, _U, _U, _P, _I, _P),
    "polar_awgn_lines": (_I, _I, _F, _F, _P, _P, _P, _U, _U, _U, _P, _I,
                         _P),
    "polar_encode_bits": (_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                          _P),
    "polar_scratch_decode": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _P),
    "polar_scratch_decode_frames": (_P, _I, _I, _I, _P, _P, _I, _I, _I, _P),
    "polar_f32_decode_frames": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "polar_scratch_subtree": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "polar_interp_tile": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    "polar_interp_tile_occupancy": (_I, _I, _I, _I, _I, _P),
    "polar_set_device": (_I,),
    "polar_get_device": (_P,),
    "polar_ring_shift": (_P, _P, _I, _L, _I, _P),
    "polar_enable_peer": (_I, _I),
}

_lib = None


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or the default toolkit path."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise BuildError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of polar_tpu_torch "
        "are built from source at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpolar_tpu_torch_{source_hash()}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    nvcc per source, all at once, then the link. Returns the library's
    path; the compiler's output (``-Xptxas -v``: registers, spills) is
    kept beside it as ``.log``."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                for _, other in procs:   # those not yet read
                    if other.returncode is None:
                        other.kill()
                        other.communicate()
                raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                                 f"{' '.join(cmd)}\n{text}")
        lib = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc link failed ({proc.returncode}):\n"
                             f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream(device) -> int:
    """Make ``device`` (a CUDA ``torch.device``; without an index, torch's
    current device) the library's current device and return the handle of
    its current torch stream, for a launch on that device.

    The library links the CUDA runtime statically and keeps its own current
    device (``csrc/device.cu``), which no torch call moves: every wrapper
    calls this right before its launch, so its kernel runs on the device
    that holds its tensors."""
    import torch

    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    check(load_library().polar_set_device(index), "polar_set_device")
    return torch.cuda.current_stream(index).cuda_stream


def current_device() -> int:
    """The library's current device (the one its next launch runs on
    unless :func:`stream` moves it)."""
    out = ctypes.c_int(-1)
    check(load_library().polar_get_device(ctypes.byref(out)),
          "polar_get_device")
    return out.value


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
