"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``gpud_tpu_torch/csrc/*.cu`` is compiled for ``sm_90a`` into one
shared library with a plain C interface, on first use, under
``<checkout>/build/kernels/``. The library's name carries a hash of the
sources and flags, so a stale build is never loaded. There is no fallback:
a missing or failing ``nvcc`` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# C entry points and their ctypes signatures: pointers and the stream as
# c_void_p, sizes as c_int64; each returns a cudaError_t
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    "gpud_packed_scan": [_P, _P, _P, _I64, _I64, _P, _P],
}


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpud_tpu_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    # CUDA_HOME resolves $CUDA_HOME, nvcc on PATH, then the default toolkit
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of gpud_tpu_torch need the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return str(nvcc)


def build() -> Path:
    """Compile the kernels if the hashed library is missing; return its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
