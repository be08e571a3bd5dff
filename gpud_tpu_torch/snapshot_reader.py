"""A native reader of host NVLink snapshot DBs.

``csrc/snapshot_reader.c`` steps SQLite's rows straight into a host's block
(:class:`Block`: each link's samples in a row of int8 states, int32 counters
and valid flags), where Python's ``sqlite3`` would build a tuple of four
objects a row; :class:`Reads` reads a fleet's DBs side by side on native
worker threads. It is compiled with the host's C compiler on first use
(``ops/_build.build_host``), never at import, and linked against the
libsqlite3 that the interpreter's own ``sqlite3`` module loaded, so the
SQLite version and its query plans are the same. Its calls go through
ctypes, which releases the interpreter's lock while SQLite works.

Every DB takes one walk, into its host's block. A host over several DBs
has one block: each of its DBs after the first continues it, the links
already in it taking that DB's floors, and its last DB hands it over.

The reader answers as Python's ``sqlite3``, ``np.fromiter`` and the
loader's floors did; Python judges what the C code does not:

- A failure raises the ``sqlite3`` class that Python's module raises for
  SQLite's result code, with SQLite's message.
- Tombstones that the C code does not judge (a TEXT name that is not ASCII
  or whose ts is no number, or a read that failed with another code than
  SQLITE_ERROR) are read here as ``sqlite3`` reads them (an
  ``OperationalError`` means none) and their numeric floors handed to the
  walk; after it, a link's floor that is no number raises as the loader's
  expression ``max(global_ts, tombstones.get(link, 0.0))`` and its mask did.
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
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from gpud_tpu_torch.ops import _build

TABLE = "tpud_ici_snapshots_v0_1"  # the schema of components/gpu/nvlink_store.py
TOMBSTONE_TABLE = "tpud_ici_tombstones_v0_1"
# one query a DB: it walks only the window's entries of the (ts) index, in a
# total order (ties by rowid, as the (link, ts) index orders them), so each
# link's rows come in ts order whatever depth the DB stores
QUERY = (f"SELECT link, ts, state, crc_errors FROM {TABLE} "
         "WHERE ts>=? ORDER BY ts, rowid")
TOMBSTONE_QUERY = f"SELECT link, ts FROM {TOMBSTONE_TABLE}"

# a reader thread's stack: SQLite's open, schema read, walk and close and
# the reader's C, thread-local storage included, take under 16 KB of it;
# the rest is room for SQLite's rarer paths. The 8 MB default would reserve
# 8 MB a thread
STACK_BYTES = 64 * 1024

_DONE = 101  # SQLITE_DONE
_VALUE = 1000  # csrc's TPUD_VALUE: a value for this side to convert
_FLOORS = 1002  # csrc's TPUD_FLOORS: tombstones for this side to judge
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


class _Block(ctypes.Structure):
    """The public head of ``tpud_block``."""

    _fields_ = [("links", _Names), ("kept", ctypes.POINTER(ctypes.c_int64)),
                ("t", ctypes.c_int64), ("buf", ctypes.c_void_p), ("bytes", ctypes.c_int64)]


class _Reader(ctypes.Structure):
    """The public head of ``tpud_reader``; the C side allocates the rest."""

    _fields_ = [
        ("errcode", ctypes.c_int64), ("errmsg", ctypes.c_void_p),
        ("tomb_rc", ctypes.c_int64), ("n_tombstones", ctypes.c_int64),
        ("tombstones", ctypes.POINTER(_Value)),
        ("n_rows", ctypes.c_int64), ("n_tombstoned", ctypes.c_int64),
        ("bad_col", ctypes.c_int64), ("bad", _Value),
        ("b", ctypes.POINTER(_Block)),
    ]


_Handle = ctypes.POINTER(_Reader)


class _Job(ctypes.Structure):
    """``tpud_job``: one DB's read by a pool."""

    _fields_ = [
        ("uri", ctypes.c_char_p), ("tombstone_sql", ctypes.c_char_p), ("sql", ctypes.c_char_p),
        ("start", ctypes.c_double), ("max_samples", ctypes.c_int64),
        ("first", ctypes.c_int64), ("last", ctypes.c_int64), ("b", ctypes.c_void_p),
        ("h", _Handle), ("opened", ctypes.c_int64), ("rc", ctypes.c_int64),
        ("open_s", ctypes.c_double), ("fetch_s", ctypes.c_double), ("cpu_s", ctypes.c_double),
        ("wait_s", ctypes.c_double), ("on_worker", ctypes.c_int64),
    ]


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
        ("tpud_walk", [_Handle, text, f64, ctypes.POINTER(_Value), i64]),
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


def _judge_floors(tombstones: Dict, links: List[str]) -> None:
    """Raises where the loader's floor of one of ``links`` (a host's, in
    the order first fetched) is no number, as its expression and its mask
    raised: NumPy compares no times with floors that are strings."""
    global_ts = tombstones.get("*", 0.0)
    floors = np.array([max(global_ts, tombstones.get(link, 0.0)) for link in links])
    np.zeros(0) >= floors[:0]  # noqa: B015 (evaluated for what it raises)


class SnapshotDB:
    """One host DB, opened read-only with its tombstones read, and its walk
    into its host's block; the handle is freed by :meth:`close`."""

    def __init__(self, uri: str):
        """Open ``uri`` (a ``file:`` URI, as ``sqlite3.connect(uri=True)``
        takes it) and read its tombstone rows."""
        self._lib = _library()
        self._h = _Handle()
        rc = self._lib.tpud_open(uri.encode(), TOMBSTONE_QUERY.encode(), ctypes.byref(self._h))
        if rc:
            try:
                self._raise(rc)
            finally:
                self.close()

    @classmethod
    def _adopt(cls, handle) -> "SnapshotDB":
        """The DB of a handle that a pool opened."""
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
        """The tombstone rows as ``dict(conn.execute(TOMBSTONE_QUERY))``
        gives them; the read's failure raises here."""
        r = self._h.contents
        if r.tomb_rc:
            self._raise(r.tomb_rc)
        t = r.tombstones
        return dict((_as_python(t[2 * k], "link"), _as_python(t[2 * k + 1], "ts"))
                    for k in range(r.n_tombstones))

    def walk(self, tombstones: Dict, start: float) -> int:
        """Walk the window from ``start`` with the floors of ``tombstones``
        whose name is TEXT and whose ts is a number; return the walk's code
        for :meth:`finish`."""
        rows = [(k.encode(), float(v)) for k, v in tombstones.items()
                if isinstance(k, str) and isinstance(v, (int, float))]
        names = ctypes.create_string_buffer(b"".join(name for name, _ts in rows))
        values, at = (_Value * (2 * len(rows)))(), ctypes.addressof(names)
        for k, (name, ts) in enumerate(rows):
            values[2 * k].type, values[2 * k].p, values[2 * k].n = 3, at, len(name)
            values[2 * k + 1].type, values[2 * k + 1].f = 2, ts
            at += len(name)
        return self._lib.tpud_walk(self._h, QUERY.encode(), start, values, len(rows))

    def finish(self, rc: int) -> None:
        """Go on with the walk from its code ``rc``, converting each value the
        C side hands back, to its end. A failure raises."""
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
        if rc != _DONE:
            self._raise(rc)

    def _block(self) -> Tuple[List[str], np.ndarray]:
        """The host's block's link names by id, numbered in the order first
        fetched, and the samples each kept."""
        b = self._h.contents.b.contents
        n, links = b.links.n, b.links
        ends = np.ctypeslib.as_array(links.ends, (n,)).tolist() if n else [0]
        raw = ctypes.string_at(links.names, ends[-1])
        names = [_text(raw[a:b], "link") for a, b in zip([0, *ends], ends[:n])]
        return names, np.ctypeslib.as_array(b.kept, (n,)).copy() if n else np.zeros(0, np.int64)

    def _take_pages(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The closed block's states, counters and valid flags, [links, t]
        each, over its pages, which they now own: the pages are unmapped when
        the last array over them is gone."""
        b = self._h.contents.b.contents
        shape = (b.links.n, b.t)
        cells = shape[0] * shape[1]
        if not cells:
            return (np.zeros(shape, np.int8), np.zeros(shape, np.int32), np.zeros(shape, bool))
        buf = (ctypes.c_char * (6 * cells)).from_address(b.buf)
        buf.owner = _Pages(self._lib.tpud_unmap, b.buf, b.bytes)
        b.buf, b.bytes = None, 0
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
    """A host's block: row k is link k's, in the order first fetched;
    ``kept[k]`` its samples at or after its set-healthy floor, before the
    cut to the latest ``max_samples``; each row's samples left-aligned in ts
    order, ``t`` wide (the most any link keeps), the counters rebased on
    each link's first kept sample and clipped to int32."""

    names: List[str]
    kept: np.ndarray        # int64, a link
    states: np.ndarray      # [links, t] int8
    counters: np.ndarray    # [links, t] int32, rebased on each link's first kept sample
    valid: np.ndarray       # [links, t] bool, a prefix of each row


class Read(NamedTuple):
    """One DB as :class:`Reads` hands it over, its walk finished."""

    links: List[str]        # the host's links that kept a sample in this DB
    block: Optional[Block]  # the host's block, at its last DB
    fetched: int            # rows the query returned
    tombstoned: int         # of them, dropped by a floor
    open_s: float           # the open, the tombstones and their floors, the block made
    fetch_s: float          # the walk, the DB's close and the block's
    cpu_s: float            # the read's thread CPU, its threads' summed
    wait_s: float           # the taking thread blocked on the read's worker
    on_worker: bool         # the DB was opened on a worker thread


class Reads:
    """Host DBs (``uris``; ``hosts[i]`` the host of DB i) read by the native
    side: each opened, its tombstones read and judged into floors, its window
    walked into its host's block. With ``workers`` of 2 or more each DB is
    read whole on one of as many native threads of ``STACK_BYTES`` stacks
    (opened, its host's first DB walked to the end and closed), at most that
    many DBs ahead of the last one :meth:`take` took; else (``workers`` 0)
    the read is :meth:`take`'s. A DB after its host's first, or whose floors
    Python judges, is walked by :meth:`take`. A block is first sized as the
    largest block read before it. Leaving the ``with`` block waits for the
    reads running and closes the DBs and blocks not taken."""

    def __init__(self, uris: List[str], hosts: List[str], start: float, max_samples: int,
                 workers: int):
        if max_samples < 1:
            raise ValueError(f"max_samples must be at least 1, not {max_samples}")
        self._lib = _library()
        self._text = [x.encode() for x in (TOMBSTONE_QUERY, QUERY, *uris)]
        self._jobs = (_Job * len(uris))()
        first, last = {}, {}
        for i, host in enumerate(hosts):
            first.setdefault(host, i)
            last[host] = i
        for i, (job, uri, host) in enumerate(zip(self._jobs, self._text[2:], hosts)):
            job.uri, job.tombstone_sql, job.sql = uri, *self._text[:2]
            job.start, job.max_samples = start, max_samples
            job.first, job.last = first[host], last[host] == i
        self._start = start
        self._kept: Dict[int, np.ndarray] = {}  # a host's first DB: its links' kept so far
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
        """DB ``i``, the one after the last taken, once read. A DB that would
        not open raises here, as :class:`SnapshotDB` raises, and so does its
        walk's failure."""
        self._lib.tpud_pool_take(self._pool, i)
        job = self._jobs[i]
        t0, cpu0 = time.perf_counter(), time.thread_time()
        open_s = 0.0
        with SnapshotDB._adopt(job.h) as db:
            job.h = None
            rc, tombstones = job.rc, None
            if not job.opened:
                db._raise(rc)
            if rc == _FLOORS:
                try:
                    tombstones = db.tombstones()
                except sqlite3.OperationalError:
                    tombstones = {}  # older DB without the table
                open_s = time.perf_counter() - t0
                rc = db.walk(tombstones, self._start)
            db.finish(rc)
            names, kept = db._block()
            if tombstones:
                _judge_floors(tombstones, names)
            grew = kept.copy()
            before = self._kept.pop(job.first, grew[:0])
            grew[:len(before)] -= before
            links = [names[k] for k in np.flatnonzero(grew)]
            block = Block(names, kept, *db._take_pages()) if job.last else None
            if not job.last:
                self._kept[job.first] = kept
            r = db._h.contents
            fetched, tombstoned = r.n_rows, r.n_tombstoned
        fetch_s = time.perf_counter() - t0 - open_s
        return Read(links, block, fetched, tombstoned, job.open_s + open_s,
                    job.fetch_s + fetch_s, job.cpu_s + time.thread_time() - cpu0, job.wait_s,
                    bool(job.on_worker))
