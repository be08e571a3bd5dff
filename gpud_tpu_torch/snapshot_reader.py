"""A native columnar reader of one host's NVLink snapshot DB.

``csrc/snapshot_reader.c`` steps SQLite's rows straight into four NumPy
columns (link id, ts, state, CRC), where Python's ``sqlite3`` would build a
tuple of four objects a row. It is compiled with the host's C compiler on
first use (``ops/_build.build_host``), never at import, and linked against
the libsqlite3 that the interpreter's own ``sqlite3`` module loaded, so the
SQLite version and its query plans are the same. Its calls go through
ctypes, which releases the interpreter's lock while SQLite works.

The reader answers as Python's ``sqlite3`` and ``np.fromiter`` did:

- A failure raises the ``sqlite3`` class that Python's module raises for
  SQLite's result code, with SQLite's message.
- A value the C code does not convert itself (a NULL, TEXT or BLOB number, a
  REAL state or CRC, a state outside int8) is handed back, converted here
  by ``np.fromiter`` as a batch of the Python loader was, and the walk goes
  on; what ``np.fromiter`` raises on it propagates. Link names are TEXT: a
  name of another type raises ``TypeError``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sqlite3
from typing import Dict, List, Tuple

import numpy as np

from gpud_tpu_torch.ops import _build

# rows the columns hold before they first grow; each growth doubles them
FIRST_ROWS = 512

_DONE = 101  # SQLITE_DONE
_VALUE = 1000  # csrc's TPUD_VALUE: a value for this side to convert
_TYPES = {1: "INTEGER", 2: "REAL", 3: "TEXT", 4: "BLOB", 5: "NULL"}
# the window query's columns and the dtype each is read into
_COLUMNS = (("link", None), ("ts", np.float64), ("state", np.int8),
            ("crc_errors", np.int64))

# Python's sqlite3 class for each primary result code (CPython's
# Modules/_sqlite/util.c); SQLITE_NOMEM (7) raises MemoryError, any code not
# listed DatabaseError
_ERRORS = {
    **dict.fromkeys((1, 3, 4, 5, 6, 8, 9, 10, 13, 14, 15, 16, 17), sqlite3.OperationalError),
    2: sqlite3.InternalError, 12: sqlite3.InternalError,
    11: sqlite3.DatabaseError,
    18: sqlite3.DataError,
    19: sqlite3.IntegrityError, 20: sqlite3.IntegrityError,
    21: sqlite3.InterfaceError, 25: sqlite3.InterfaceError,
}
_NOMEM = 7


class _Value(ctypes.Structure):
    """``tpud_value``: one value as SQLite typed it."""

    _fields_ = [("type", ctypes.c_int64), ("i", ctypes.c_int64), ("f", ctypes.c_double),
                ("p", ctypes.c_void_p), ("n", ctypes.c_int64)]


class _Reader(ctypes.Structure):
    """The public head of ``tpud_reader``; the C side allocates the rest."""

    _fields_ = [
        ("errcode", ctypes.c_int64), ("errmsg", ctypes.c_void_p),
        ("tomb_rc", ctypes.c_int64), ("n_tombstones", ctypes.c_int64),
        ("tombstones", ctypes.POINTER(_Value)),
        ("n_rows", ctypes.c_int64), ("lid", ctypes.POINTER(ctypes.c_int32)),
        ("ts", ctypes.POINTER(ctypes.c_double)), ("state", ctypes.POINTER(ctypes.c_int8)),
        ("crc", ctypes.POINTER(ctypes.c_int64)),
        ("n_links", ctypes.c_int64), ("names", ctypes.c_void_p),
        ("name_ends", ctypes.POINTER(ctypes.c_int64)),
        ("bad_col", ctypes.c_int64), ("bad", _Value),
    ]


_Handle = ctypes.POINTER(_Reader)


def sqlite_library() -> str:
    """The path of the libsqlite3 that the interpreter's ``sqlite3`` module
    loaded (``sqlite3`` is imported above, so the library is mapped)."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split(maxsplit=5)[-1].strip()
            if os.path.basename(path).startswith("libsqlite3.so"):
                return path
    raise RuntimeError(
        "the interpreter's sqlite3 module has SQLite linked in statically: no "
        "libsqlite3 is loaded for the fleet loader's reader to link against")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use only) and load the reader, once per process."""
    lib = ctypes.CDLL(str(_build.build_host((sqlite_library(),))))
    for name, argtypes in (
        ("tpud_open", [ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(_Handle)]),
        ("tpud_window", [_Handle, ctypes.c_char_p, ctypes.c_double, ctypes.c_int64]),
        ("tpud_resume", [_Handle, ctypes.c_double, ctypes.c_int64]),
        ("tpud_close", [_Handle]),
        ("sqlite3_libversion", []),
    ):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = {"tpud_close": None, "sqlite3_libversion": ctypes.c_char_p}.get(
            name, ctypes.c_int)
    return lib


def sqlite_version() -> str:
    """The version of the SQLite library the reader runs on."""
    return _library().sqlite3_libversion().decode()


def _text(raw: bytes, column: str) -> str:
    """TEXT as Python's ``sqlite3`` decodes it."""
    try:
        return raw.decode()
    except UnicodeDecodeError:
        raise sqlite3.OperationalError(
            f"Could not decode to UTF-8 column '{column}' with text "
            f"'{raw.decode(errors='replace')}'") from None


def _as_python(v: _Value, column: str):
    """The value as Python's ``sqlite3`` returns it."""
    if v.type == 1:
        return v.i
    if v.type == 2:
        return v.f
    if v.type == 5:
        return None
    raw = ctypes.string_at(v.p, v.n)
    return raw if v.type == 4 else _text(raw, column)


class SnapshotDB:
    """One host DB, opened read-only with its tombstones read. Its window
    is read once; the handle and its buffers are freed by :meth:`close`."""

    def __init__(self, uri: str, tombstone_sql: str):
        """Open ``uri`` (a ``file:`` URI, as ``sqlite3.connect(uri=True)``
        takes it) and read ``tombstone_sql``'s (link, ts) rows."""
        self._lib = _library()
        self._h = _Handle()
        rc = self._lib.tpud_open(uri.encode(), tombstone_sql.encode(), ctypes.byref(self._h))
        if rc:
            try:
                self._raise(rc)
            finally:
                self.close()

    def __enter__(self) -> "SnapshotDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._h:
            self._lib.tpud_close(self._h)
            self._h = _Handle()

    def _raise(self, rc: int):
        if rc == _NOMEM or not self._h:
            raise MemoryError()
        r = self._h.contents
        msg = ctypes.string_at(r.errmsg).decode(errors="replace") if r.errmsg else ""
        exc = _ERRORS.get(rc, sqlite3.DatabaseError)(msg)
        exc.sqlite_errorcode = r.errcode
        raise exc

    def tombstones(self) -> Dict:
        """The tombstone rows as ``dict(conn.execute(tombstone_sql))`` gives
        them; the read's failure raises here."""
        r = self._h.contents
        if r.tomb_rc:
            self._raise(r.tomb_rc)
        t = r.tombstones
        return dict((_as_python(t[2 * k], "link"), _as_python(t[2 * k + 1], "ts"))
                    for k in range(r.n_tombstones))

    def window(self, sql: str, start: float) -> Tuple[List[str], Tuple[np.ndarray, ...]]:
        """Run ``sql`` (columns link, ts, state, crc_errors; one parameter,
        bound to ``start``) to its end, then close the DB. Returns the link
        names by id, numbered in the order first fetched, and the columns
        (link id int32, ts float64, state int8, CRC int64), each exactly the
        rows long."""
        lib, h = self._lib, self._h
        rc = lib.tpud_window(h, sql.encode(), start, FIRST_ROWS)
        while rc == _VALUE:
            r = h.contents
            column, dtype = _COLUMNS[r.bad_col]
            value = _as_python(r.bad, column)
            if dtype is None:
                raise TypeError(f"a link name of SQLite type {_TYPES[r.bad.type]}: the "
                                "fleet loader reads TEXT link names")
            x = np.fromiter([value], dtype, 1)[0]
            rc = (lib.tpud_resume(h, float(x), 0) if dtype is np.float64
                  else lib.tpud_resume(h, 0.0, int(x)))
        if rc != _DONE:
            self._raise(rc)
        r = h.contents
        n = r.n_rows
        columns = tuple(np.ctypeslib.as_array(p, (n,)).copy()
                        for p in (r.lid, r.ts, r.state, r.crc))
        ends = np.ctypeslib.as_array(r.name_ends, (r.n_links,)).tolist() if r.n_links else [0]
        raw = ctypes.string_at(r.names, ends[-1])
        names = [_text(raw[a:b], "link") for a, b in zip([0, *ends], ends[:r.n_links])]
        return names, columns
