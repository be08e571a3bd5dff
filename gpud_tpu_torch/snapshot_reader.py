"""A native reader of host NVLink snapshot DBs.

``csrc/snapshot_reader.c`` steps SQLite's rows straight into a host's
block (:class:`Block`: each link's samples in a row of int8 states, int32
counters and valid flags) or into four NumPy columns
(:meth:`SnapshotDB.window`: link id, ts, state, CRC), where Python's
``sqlite3`` would build a tuple of four objects a row; :class:`Reads` walks
a fleet's DBs side by side on native worker threads. It is compiled with
the host's C compiler on first use (``ops/_build.build_host``), never at
import, and linked against the libsqlite3 that the interpreter's own
``sqlite3`` module loaded, so the SQLite version and its query plans are
the same. Its calls go through ctypes, which releases the interpreter's
lock while SQLite works.

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
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from gpud_tpu_torch.ops import _build

# rows the columns hold before they first grow; each growth doubles them
FIRST_ROWS = 512
# a reader thread's stack: SQLite's walk and the reader's C, thread-local
# storage included, take under 16 KB of it. Where the system commits a
# touched stack whole (a user-space kernel may), each thread costs this much resident
# memory, not the 8 MB default's
STACK_BYTES = 64 * 1024

_DONE = 101  # SQLITE_DONE
_VALUE = 1000  # csrc's TPUD_VALUE: a value for this side to convert
_REREAD = 1001  # csrc's TPUD_REREAD: a block the C side cannot make exactly
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


class _Names(ctypes.Structure):
    """``name_table``: the link names by id, end to end."""

    _fields_ = [("n", ctypes.c_int64), ("names", ctypes.c_void_p),
                ("ends", ctypes.POINTER(ctypes.c_int64)), ("names_cap", ctypes.c_int64),
                ("ends_cap", ctypes.c_int64), ("slots", ctypes.c_void_p),
                ("n_slots", ctypes.c_int64)]


class _Reader(ctypes.Structure):
    """The public head of ``tpud_reader``; the C side allocates the rest."""

    _fields_ = [
        ("errcode", ctypes.c_int64), ("errmsg", ctypes.c_void_p),
        ("tomb_rc", ctypes.c_int64), ("n_tombstones", ctypes.c_int64),
        ("tombstones", ctypes.POINTER(_Value)),
        ("n_rows", ctypes.c_int64), ("lid", ctypes.POINTER(ctypes.c_int32)),
        ("ts", ctypes.POINTER(ctypes.c_double)), ("state", ctypes.POINTER(ctypes.c_int8)),
        ("crc", ctypes.POINTER(ctypes.c_int64)),
        ("links", _Names),
        ("bad_col", ctypes.c_int64), ("bad", _Value),
        ("n_tombstoned", ctypes.c_int64), ("t", ctypes.c_int64),
        ("b_buf", ctypes.c_void_p), ("b_bytes", ctypes.c_int64),
        ("kept", ctypes.POINTER(ctypes.c_int64)),
        ("_db", ctypes.c_void_p), ("_stmt", ctypes.c_void_p), ("block", ctypes.c_int),
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


_VOID = ("tpud_close", "tpud_unmap", "tpud_pool_take", "tpud_pool_stop")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use only) and load the reader, once per process."""
    lib = ctypes.CDLL(str(_build.build_host((sqlite_library(),))))
    i64, f64, text = ctypes.c_int64, ctypes.c_double, ctypes.c_char_p
    for name, argtypes in (
        ("tpud_open", [text, text, ctypes.POINTER(_Handle)]),
        ("tpud_window", [_Handle, text, f64, i64]),
        ("tpud_resume", [_Handle, f64, i64]),
        ("tpud_close", [_Handle]),
        ("tpud_unmap", [ctypes.c_void_p, i64]),
        ("tpud_pool_start", [ctypes.POINTER(_Job), i64, i64, i64]),
        ("tpud_pool_threads", [ctypes.c_void_p]),
        ("tpud_pool_take", [ctypes.c_void_p, i64]),
        ("tpud_pool_stop", [ctypes.c_void_p]),
        ("sqlite3_libversion", []),
    ):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = {"sqlite3_libversion": ctypes.c_char_p, "tpud_pool_start": ctypes.c_void_p,
                      "tpud_pool_threads": i64}.get(
            name, None if name in _VOID else ctypes.c_int)
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

    @classmethod
    def _adopt(cls, handle) -> "SnapshotDB":
        """The DB of a handle that ``tpud_read`` opened."""
        db = cls.__new__(cls)
        db._lib, db._h = _library(), _Handle(handle.contents) if handle else _Handle()
        return db

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
        return self.finish(self._lib.tpud_window(self._h, sql.encode(), start, FIRST_ROWS))

    def finish(self, rc: int):
        """Go on with the walk from its code ``rc``, converting each value the
        C side hands back, to its end; return what :meth:`window` returns, or
        for a block's walk its :class:`Block` (None where the block cannot be
        made exactly: a cut link whose counter left int32 before the cut).
        A failure raises."""
        lib, h = self._lib, self._h
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
        if rc == _REREAD:
            return None
        if rc != _DONE:
            self._raise(rc)
        r = h.contents
        if not r.block:
            n = r.n_rows
            return self._names(), tuple(np.ctypeslib.as_array(p, (n,)).copy()
                                        for p in (r.lid, r.ts, r.state, r.crc))
        kept = np.ctypeslib.as_array(r.kept, (r.links.n,)).copy() if r.links.n else (
            np.zeros(0, np.int64))
        return Block(self._names(), kept, *self._take_block(), r.n_rows, r.n_tombstoned)

    def _names(self) -> List[str]:
        """The link names by id, numbered in the order first fetched."""
        links = self._h.contents.links
        ends = np.ctypeslib.as_array(links.ends, (links.n,)).tolist() if links.n else [0]
        raw = ctypes.string_at(links.names, ends[-1])
        return [_text(raw[a:b], "link") for a, b in zip([0, *ends], ends[:links.n])]

    def _take_block(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The block's states, counters and valid flags, [links, t] each,
        over its pages, which they now own: the pages are unmapped when the
        last array over them is gone."""
        r = self._h.contents
        shape = (r.links.n, r.t)
        cells = shape[0] * shape[1]
        if not cells:
            return (np.zeros(shape, np.int8), np.zeros(shape, np.int32), np.zeros(shape, bool))
        buf = (ctypes.c_char * (6 * cells)).from_address(r.b_buf)
        buf.owner = _Pages(self._lib.tpud_unmap, r.b_buf, r.b_bytes)
        r.b_buf, r.b_bytes = None, 0
        # the C side's layout: counters, then states, then valid flags
        return tuple(np.frombuffer(buf, dtype, cells, offset).reshape(shape)
                     for dtype, offset in ((np.int8, 4 * cells), (np.int32, 0),
                                           (bool, 5 * cells)))


class _Pages:
    """Pages the reader mapped for a block; unmapped with the last array over
    them."""

    def __init__(self, unmap, address: int, nbytes: int):
        self._unmap, self._address, self._nbytes = unmap, address, nbytes

    def __del__(self):
        self._unmap(self._address, self._nbytes)


class Block(NamedTuple):
    """One DB's block: row k is link k's, in the order first fetched;
    ``kept[k]`` its samples at or after its set-healthy floor, before the
    cut to the latest ``max_samples``; each row's samples left-aligned in ts
    order, ``t`` wide (the most any link keeps), the counters rebased on
    each link's first kept sample and clipped to int32."""

    names: List[str]
    kept: np.ndarray        # int64, a link
    states: np.ndarray      # [links, t] int8
    counters: np.ndarray    # [links, t] int32, rebased on each link's first kept sample
    valid: np.ndarray       # [links, t] bool, a prefix of each row
    fetched: int            # rows the query returned
    tombstoned: int         # of them, dropped by a floor


class _Job(ctypes.Structure):
    """``tpud_job``: one DB's read by a pool."""

    _fields_ = [
        ("uri", ctypes.c_char_p), ("tombstone_sql", ctypes.c_char_p), ("sql", ctypes.c_char_p),
        ("last_sql", ctypes.c_char_p),
        ("start", ctypes.c_double), ("max_samples", ctypes.c_int64),
        ("as_block", ctypes.c_int64), ("rows0", ctypes.c_int64),
        ("h", _Handle), ("opened", ctypes.c_int64), ("rc", ctypes.c_int64),
        ("open_s", ctypes.c_double), ("fetch_s", ctypes.c_double), ("cpu_s", ctypes.c_double),
        ("wait_s", ctypes.c_double),
    ]


class Read(NamedTuple):
    """One DB as :class:`Reads` hands it over: its handle, the code its walk
    stopped at (for :meth:`SnapshotDB.finish`; ``FLOORS``: no walk started,
    the tombstones are the caller's to judge) and the read's seconds."""

    db: SnapshotDB
    rc: int
    open_s: float           # the open, the tombstones and their floors
    fetch_s: float          # the walk
    cpu_s: float            # the read's thread CPU, its threads' summed
    wait_s: float           # the taking thread blocked on the walk's worker


FLOORS = 1002  # csrc's TPUD_FLOORS


class Reads:
    """Host DBs read by the native side: each opened, its tombstones read and
    judged into floors, its window walked into a block (``as_block``) or
    into columns; ``last_sql`` gives the largest ts and its rows' count,
    where a worker's walk stops (the step that ends it is the taking
    thread's). With ``workers`` of 2 or more the reads run on as many
    native threads of ``STACK_BYTES`` stacks, at most that many DBs ahead of
    :meth:`take`; else (``workers`` 0) each is read inline as it is taken.
    A read stops where only Python can go on (see :class:`Read`). A block
    is first sized as the largest block read before it. Leaving the
    ``with`` block waits for the reads running and closes the DBs not
    taken."""

    def __init__(self, uris: List[str], as_block: List[bool], tombstone_sql: str, sql: str,
                 last_sql: str, start: float, max_samples: int, workers: int):
        self._lib = _library()
        self._text = [x.encode() for x in (tombstone_sql, sql, last_sql, *uris)]
        self._jobs = (_Job * len(uris))()
        for job, uri, block in zip(self._jobs, self._text[3:], as_block):
            job.uri, job.tombstone_sql, job.sql, job.last_sql = uri, *self._text[:3]
            job.start, job.max_samples, job.as_block = start, max_samples, block
            job.rows0 = FIRST_ROWS
        self._asked = workers
        self.workers = 0
        self._pool = None

    def __enter__(self) -> "Reads":
        self._pool = self._lib.tpud_pool_start(self._jobs, len(self._jobs), self._asked,
                                               STACK_BYTES)
        if not self._pool:
            raise MemoryError()
        self.workers = self._lib.tpud_pool_threads(self._pool)
        return self

    def __exit__(self, *exc) -> None:
        self._lib.tpud_pool_stop(self._pool)
        self._pool = None

    def take(self, i: int) -> Read:
        """DB ``i``, the one after the last taken, once read; its handle is
        the caller's. A DB that would not open raises here, as
        :class:`SnapshotDB` raises."""
        self._lib.tpud_pool_take(self._pool, i)
        job = self._jobs[i]
        db = SnapshotDB._adopt(job.h)
        job.h = None
        if not job.opened:
            with db:
                db._raise(job.rc)
        return Read(db, job.rc, job.open_s, job.fetch_s, job.cpu_s, job.wait_s)
