"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``gpud_tpu_torch/csrc/*.cu`` is compiled for ``sm_90a`` into one
shared library with a plain C interface, on first use, under
``<checkout>/build/kernels/``. The library's name carries a hash of the
sources and flags, so a stale build is never loaded. There is no fallback:
a missing or failing ``nvcc`` raises with the compiler's output. What
``ptxas`` reports of each kernel (registers, spills, shared memory) is kept
beside the library and read back by :func:`kernel_resources`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory, to stderr
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
    _ptxas_log(so).write_text(proc.stderr)  # before the library appears
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def _ptxas_log(so: Path) -> Path:
    return so.with_suffix(".ptxas.txt")


def _unqualified(mangled: str) -> str:
    """The last name part of an Itanium-mangled function name
    (``_ZN12_GLOBAL__N_14scanE...`` -> ``scan``); other names as they are."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while m := re.match(r"\d+", mangled[i:]):
        n = int(m.group())
        i += m.end()
        name, i = mangled[i:i + n], i + n
    return name


def parse_ptxas(text: str) -> dict:
    """Per kernel, from ``nvcc -Xptxas -v`` output: registers, spill stores
    and loads, stack frame and static shared memory, in bytes."""
    out, entry, props = {}, None, None
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            entry = out.setdefault(_unqualified(m.group(1)), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0,
                "stack_bytes": 0, "smem_bytes": 0})
        elif m := re.search(r"Function properties for (\S+)", ln):
            props = out.get(_unqualified(m.group(1)))  # None: not a kernel
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", ln):
            if props is not None:
                props["stack_bytes"], props["spill_stores"], props["spill_loads"] = (
                    int(g) for g in m.groups())
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry is not None:
            entry["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", ln):
                entry["smem_bytes"] = int(sm.group(1))
    return out


def kernel_resources() -> dict:
    """What ptxas reported for each kernel of the current build."""
    return parse_ptxas(_ptxas_log(build()).read_text())


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
