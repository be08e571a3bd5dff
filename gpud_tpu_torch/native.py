"""Loads and builds the native C++ hot-path library; the port of
``gpud_tpu/native.py``.

The library is host C++ (``native/tpud_native.cpp`` at the repo root, the
reference's source, compiled as it is) and strictly a fast path: every
entry point has a pure-Python twin with identical semantics
(kmsg/watcher.parse_line, kmsg/deduper.Deduper, the GPU catalog's prefilter
regex, NVLinkStore's Python scan), and tests assert parity. Binding is
ctypes over a C ABI.

``build()`` compiles the source with ``g++`` into ``build/native/``; nothing
compiles at import. ``load()`` searches ``TPUD_NATIVE_LIB``, then
``build/native/libtpud_native.so``, then the system loader. It never loads
the reference's in-tree ``native/libtpud_native.so``. Absence is fine: the
Python twins run, and ``backend()`` says which path is live.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "tpud_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
LIB_NAME = "libtpud_native.so"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
BUILD_TIMEOUT = 300.0

_LIB: Optional[ctypes.CDLL] = None
_PATH = ""
_TRIED = False


class _KmsgRec(ctypes.Structure):
    _fields_ = [
        ("priority", ctypes.c_int32),
        ("facility", ctypes.c_int32),
        ("sequence", ctypes.c_int64),
        ("ts_us", ctypes.c_int64),
        ("msg_offset", ctypes.c_int32),
    ]


class _LinkScan(ctypes.Structure):
    _fields_ = [
        ("drops", ctypes.c_int32),
        ("flaps", ctypes.c_int32),
        ("currently_down", ctypes.c_int32),
        ("samples", ctypes.c_int32),
        ("counter_delta", ctypes.c_int64),
    ]


def _candidates() -> List[str]:
    out = []
    env = os.environ.get("TPUD_NATIVE_LIB", "")
    if env:
        out.append(env)
    out.append(str(BUILD_DIR / LIB_NAME))
    out.append(LIB_NAME)
    return out


def build(out_dir: Optional[Path] = None) -> Path:
    """Compile ``native/tpud_native.cpp`` with ``g++ -O2 -fPIC -std=c++17
    -shared`` into ``out_dir`` (default ``build/native/``) and return the
    library's path. The file is written under a temporary name and renamed,
    so a concurrent ``load()`` never sees half a library. A failed load
    before the build is forgotten, so the next ``load()`` searches again."""
    global _TRIED
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    out = Path(out_dir) if out_dir is not None else BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    lib = out / LIB_NAME
    tmp = out / f".{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=BUILD_TIMEOUT,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, lib)
    if _LIB is None:
        _TRIED = False
    return lib


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _PATH, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in _candidates():
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        try:
            lib.tpud_parse_kmsg.restype = ctypes.c_int
            lib.tpud_parse_kmsg.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_KmsgRec)
            ]
            lib.tpud_scan_links_ragged.restype = None
            lib.tpud_scan_links_ragged.argtypes = [
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(_LinkScan),
            ]
            lib.tpud_deduper_new.restype = ctypes.c_void_p
            lib.tpud_deduper_new.argtypes = [ctypes.c_double, ctypes.c_int64]
            lib.tpud_deduper_free.argtypes = [ctypes.c_void_p]
            lib.tpud_deduper_seen.restype = ctypes.c_int
            lib.tpud_deduper_seen.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double
            ]
            lib.tpud_deduper_len.restype = ctypes.c_int64
            lib.tpud_deduper_len.argtypes = [ctypes.c_void_p]
        except AttributeError:
            continue
        # newer optional symbols: a stale .so keeps every fast path it
        # DOES have — missing ones simply stay on the Python fallback
        try:
            lib.tpud_prefilter_init.restype = ctypes.c_int
            lib.tpud_prefilter_init.argtypes = [ctypes.c_char_p]
            lib.tpud_prefilter_match.restype = ctypes.c_int
            lib.tpud_prefilter_match.argtypes = [ctypes.c_char_p]
        except AttributeError:
            logger.info("native library lacks the prefilter (older build)")
        _LIB = lib
        _PATH = path
        logger.info("native library loaded from %s", path)
        return _LIB
    return None


def available() -> bool:
    return load() is not None


def backend() -> str:
    """``"native"`` when the library is loaded, else ``"python"``."""
    return "native" if available() else "python"


def loaded_path() -> str:
    """Where the loaded library came from ("" when none is loaded)."""
    return _PATH if available() else ""


# -- typed wrappers -----------------------------------------------------------

def parse_kmsg(line: str) -> Optional[Tuple[int, int, int, int, str]]:
    """Returns (priority, facility, sequence, ts_us, message) or None."""
    lib = load()
    if lib is None:
        return None
    raw = line.encode("utf-8", "replace")
    rec = _KmsgRec()
    if not lib.tpud_parse_kmsg(raw, ctypes.byref(rec)):
        return None
    return (
        rec.priority,
        rec.facility,
        rec.sequence,
        rec.ts_us,
        raw[rec.msg_offset:].decode("utf-8", "replace"),
    )


def _scan_results(out) -> List[dict]:
    return [
        {
            "drops": r.drops,
            "flaps": r.flaps,
            "currently_down": bool(r.currently_down),
            "samples": r.samples,
            "counter_delta": r.counter_delta,
        }
        for r in out
    ]


def scan_links_ragged(states: List[int], counters: List[int],
                      offsets: List[int]) -> Optional[List[dict]]:
    """Scan packed per-link sequences. Returns per-link dicts or None when
    the native library is absent."""
    lib = load()
    if lib is None:
        return None
    n_links = len(offsets) - 1
    st = (ctypes.c_int8 * len(states))(*states)
    ct = (ctypes.c_int64 * len(counters))(*counters)
    off = (ctypes.c_int32 * len(offsets))(*offsets)
    out = (_LinkScan * n_links)()
    lib.tpud_scan_links_ragged(st, ct, off, n_links, out)
    return _scan_results(out)


def scan_links_ragged2(
    states: List[int],
    counters_a: List[int],
    counters_b: List[int],
    offsets: List[int],
) -> Optional[Tuple[List[dict], List[dict]]]:
    """Two-counter variant (error + CRC deltas over the same state walk);
    packs states/offsets once instead of marshalling them per call."""
    lib = load()
    if lib is None:
        return None
    n_links = len(offsets) - 1
    st = (ctypes.c_int8 * len(states))(*states)
    off = (ctypes.c_int32 * len(offsets))(*offsets)
    out_a = (_LinkScan * n_links)()
    out_b = (_LinkScan * n_links)()
    lib.tpud_scan_links_ragged(
        st, (ctypes.c_int64 * len(counters_a))(*counters_a), off, n_links, out_a
    )
    lib.tpud_scan_links_ragged(
        st, (ctypes.c_int64 * len(counters_b))(*counters_b), off, n_links, out_b
    )
    return _scan_results(out_a), _scan_results(out_b)


class NativeDeduper:
    """ctypes wrapper over the C++ TTL cache; drop-in for kmsg.Deduper's
    seen_before contract (key = message+second bucket)."""

    def __init__(self, ttl_seconds: float, max_entries: int) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self._h = lib.tpud_deduper_new(ttl_seconds, max_entries)

    def seen(self, key: str, now: float) -> bool:
        return bool(self._lib.tpud_deduper_seen(self._h, key.encode(), now))

    def __len__(self) -> int:
        return int(self._lib.tpud_deduper_len(self._h))

    def __del__(self) -> None:
        try:
            self._lib.tpud_deduper_free(self._h)
        except Exception:  # noqa: BLE001
            pass


# -- catalog prefilter ---------------------------------------------------------

_PREFILTER_READY = False


def prefilter_init(tokens: List[str]) -> bool:
    """Push the catalog's coarse-token set into the native scanner.
    Returns True when the native prefilter is armed."""
    global _PREFILTER_READY
    lib = load()
    if lib is None or not hasattr(lib, "tpud_prefilter_init") or not tokens:
        # an EMPTY token set must not arm the native side: zero views
        # would reject every line, the opposite of the empty-regex
        # fallback semantics
        _PREFILTER_READY = False
        return False
    n = lib.tpud_prefilter_init("\n".join(tokens).encode("utf-8"))
    _PREFILTER_READY = n == len(tokens)
    return _PREFILTER_READY


def prefilter_match(line: str) -> Optional[bool]:
    """Native coarse scan; None when unavailable (caller falls back to
    the Python regex)."""
    if not _PREFILTER_READY:
        return None
    lib = _LIB
    if lib is None:
        return None
    try:
        return bool(lib.tpud_prefilter_match(line.encode("utf-8", "replace")))
    except Exception:  # noqa: BLE001 — fall back, never drop a line
        return None
