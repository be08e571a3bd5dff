"""Build the package's native code and load it with ctypes.

Every ``gpud_tpu_torch/csrc/*.cu`` is compiled for ``sm_90a`` into one
shared library with a plain C interface, on first use, under
``<checkout>/build/kernels/``; every ``csrc/*.c`` is host code, compiled
with the host's C compiler into a second library beside it
(:func:`build_host`). A library's name carries a hash of its sources and
flags, so a stale build is never loaded. There is no fallback: a missing or
failing compiler raises with its output. What ``ptxas`` reports of each
kernel (registers, spills, shared memory) is kept beside the kernel library
and read back by :func:`kernel_resources`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory, to stderr
)
CC_FLAGS = ("-std=c11", "-O2", "-Wall", "-shared", "-fPIC", "-pthread")

# C entry points and their ctypes signatures: pointers and the stream as
# c_void_p, sizes as c_int64; each returns a cudaError_t
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    "gpud_packed_scan": [_P, _P, _P, _I64, _I64, _P, _P],
}


def _sources(suffix: str = ".cu") -> list:
    return sorted(CSRC_DIR.glob(f"*{suffix}"))


def _hashed(stem: str, flags: Sequence[str], sources: list) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the kernel library for the current sources and flags is built."""
    return _hashed("libgpud_tpu_torch", NVCC_FLAGS, _sources())


def host_library_path(link: Sequence[str]) -> Path:
    """Where the host library of ``csrc/*.c`` is built, linked with ``link``
    (libraries given by path)."""
    return _hashed("libgpud_tpu_torch_host", (*CC_FLAGS, *link), _sources(".c"))


def _compile(cmd: list, so: Path, log: Optional[Path] = None) -> Path:
    """Run the compiler ``cmd`` with its output beside ``so``, then move it
    into place: atomic, so a concurrent build never sees half a file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if log is not None:
        log.write_text(proc.stderr)  # before the library appears
    os.replace(tmp, so)
    return so


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
    return _compile([_nvcc(), *NVCC_FLAGS, *map(str, _sources())], so, _ptxas_log(so))


def build_host(link: Sequence[str]) -> Path:
    """Compile ``csrc/*.c`` with the host's C compiler (``cc``), linked with
    ``link``, if the hashed library is missing; return its path."""
    so = host_library_path(link)
    if so.exists():
        return so
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("cc not found: the host library of gpud_tpu_torch needs a C "
                           "compiler on PATH")
    return _compile([cc, *CC_FLAGS, *map(str, _sources(".c")), *link], so)


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
