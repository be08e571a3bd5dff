"""The port's fleet-scan loader (gpud_tpu_torch/fleet_scan.py
``load_fleet_history``) on the store's own schema: its query walks the
window on the ``(ts)`` index whatever depth the DB holds, it holds no
Python object per row (its arrays equal the reference's in
tests/test_torch_fleet_scan.py), and its native reader
(gpud_tpu_torch/snapshot_reader.py) reads what a plain ``sqlite3`` reader
reads, walks each DB into the block the reference loader packs, and raises
what they raised."""

import json
import os
import shutil
import sqlite3
import subprocess
import sys
import textwrap
import threading
import time
import tracemalloc
from pathlib import Path
from urllib.parse import quote

import numpy as np
import pytest

from gpud_tpu import fleet_scan as jax_fs

from gpud_tpu_torch import fleet_scan as torch_fs
from gpud_tpu_torch import snapshot_reader
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore
from gpud_tpu_torch.ops import _build
from gpud_tpu_torch.sqlite import DB
from gpud_tpu_torch.tracing import DEFAULT_TRACER

NOW = 1_700_000_000.0
TABLE = torch_fs.TABLE
REPO = Path(__file__).resolve().parent.parent
QUERY, TOMBSTONE_QUERY = snapshot_reader.QUERY, snapshot_reader.TOMBSTONE_QUERY


def _host_db(path, links, minutes, seed=0):
    """``links`` NVLink links of an 8-GPU host, one snapshot a minute for
    ``minutes`` up to NOW, written sweep by sweep as the daemon writes."""
    rng = np.random.default_rng(seed)
    db = DB(str(path))
    NVLinkStore(db)
    names = [f"gpu{k // 18}/nvlink{k % 18}" for k in range(links)]
    ts = NOW - 60 * np.arange(minutes, 0, -1) + 1
    crc = np.cumsum(rng.integers(0, 40, (minutes, links)), axis=0)
    up = (rng.random((minutes, links)) > 0.01).astype(int)
    db.executemany(f"INSERT INTO {TABLE} (ts, link, state, crc_errors) VALUES (?, ?, ?, ?)",
                   zip(np.repeat(ts, links).tolist(), names * minutes,
                       up.ravel().tolist(), crc.ravel().tolist()))
    db.close()
    return str(path)


@pytest.mark.parametrize("analyzed", [False, True], ids=["no_stats", "analyzed"])
def test_query_walks_only_the_window_on_the_ts_index(tmp_path, analyzed):
    # a day stored, an hour asked for: the plan must search the (ts) index
    # from the window's start and sort nothing
    path = _host_db(tmp_path / "h.db", links=36, minutes=24 * 60)
    conn = sqlite3.connect(path)
    try:
        if analyzed:
            conn.execute("ANALYZE")
        plan = [row[-1] for row in conn.execute("EXPLAIN QUERY PLAN " + QUERY,
                                                (NOW - 3600,))]
    finally:
        conn.close()
    assert any(f"USING INDEX idx_{TABLE}_ts (ts>?)" in step and step.startswith("SEARCH")
               for step in plan), plan
    assert not any("TEMP B-TREE" in step for step in plan), plan


# bytes the loader may hold per row fetched, besides its output arrays; a
# loader that keeps a Python object per row holds some 95 B a row
BYTES_PER_ROW = 32


def test_loader_holds_no_python_object_per_row(tmp_path):
    hosts, links, minutes = 4, 144, 240
    paths = [_host_db(tmp_path / f"host{h}.db", links, minutes, seed=h) for h in range(hosts)]
    tracemalloc.start()
    try:
        names, *arrays, truncated = torch_fs.load_fleet_history(
            paths, window_seconds=minutes * 60, now=NOW)
        _now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    rows = hosts * links * minutes
    assert len(names) == hosts * links and arrays[0].shape == (hosts * links, minutes)
    assert int(arrays[2].sum()) == rows and truncated == []
    out = sum(a.nbytes for a in arrays)
    assert peak <= out + BYTES_PER_ROW * rows, (peak, out, rows)


# DBs that the daemon's schema would refuse, written straight with sqlite3:
# an untyped column keeps what it is given (no affinity converts it)
LOOSE_DDL = f"CREATE TABLE {TABLE} (ts, link, state, crc_errors)"


def _loose_db(path, rows, ddl=LOOSE_DDL):
    conn = sqlite3.connect(path)
    try:
        conn.execute(ddl)
        conn.execute(f"CREATE INDEX idx_{TABLE}_ts ON {TABLE} (ts)")
        conn.executemany(f"INSERT INTO {TABLE} (ts, link, state, crc_errors) VALUES (?,?,?,?)",
                         rows)
        conn.commit()
    finally:
        conn.close()
    return str(path)


GOOD_ROWS = [(NOW - 120, "gpu0/nvlink0", 1, 5), (NOW - 60, "gpu0/nvlink0", 1, 7)]
COLUMN = {"ts": 0, "link": 1, "state": 2, "crc_errors": 3}


def _with(column, value):
    row = [NOW - 30, "gpu0/nvlink0", 1, 9]
    row[COLUMN[column]] = value
    return GOOD_ROWS + [tuple(row)]


@pytest.mark.parametrize("column, value, exc, message", [
    ("state", None, TypeError, "not 'NoneType'"),
    ("crc_errors", None, TypeError, "not 'NoneType'"),
    ("state", "abc", ValueError, "invalid literal for int() with base 10: 'abc'"),
    ("crc_errors", "abc", ValueError, "invalid literal for int() with base 10: 'abc'"),
    ("ts", "abc", ValueError, "could not convert string to float: 'abc'"),
    ("state", b"ab", ValueError, "invalid literal for int() with base 10: b'ab'"),
    ("ts", b"ab", ValueError, "could not convert string to float: b'ab'"),
    ("state", 200, OverflowError, "200 out of bounds for int8"),
    ("state", -129, OverflowError, "-129 out of bounds for int8"),
    ("crc_errors", 1e30, OverflowError, "too large"),
    ("state", float("inf"), OverflowError, "infinity"),
])
def test_a_value_numpy_cannot_convert_raises_as_it_did(tmp_path, column, value, exc, message):
    # NULL, TEXT or BLOB in a number's column, or a state outside int8: the
    # loader raises what np.fromiter raised on the value
    path = _loose_db(tmp_path / "h.db", _with(column, value))
    with pytest.raises(exc) as err:
        torch_fs.load_fleet_history([path], window_seconds=3600, now=NOW)
    assert message in str(err.value)


@pytest.mark.parametrize("column, value, converted", [
    ("state", 1.9, 1),            # a REAL in an integer column: int() truncates
    ("state", -1.5, -1),
    ("crc_errors", 8.7, 8),
    ("state", "0", 0),            # a numeral as TEXT: np.fromiter parses it
    ("crc_errors", b"12", 12),
    ("ts", "1699999990.5", 1699999990.5),
    ("ts", int(NOW) - 10, NOW - 10),  # an INTEGER time
])
def test_a_value_numpy_converts_converts_as_it_did(tmp_path, column, value, converted):
    path = _loose_db(tmp_path / "h.db", _with(column, value))
    names, states, counters, valid, _t = torch_fs.load_fleet_history(
        [path], window_seconds=3600, now=NOW)
    assert names == ["h/gpu0/nvlink0"] and valid.tolist() == [[True] * 3]
    if column == "state":
        assert states.tolist() == [[1, 1, converted]]
    elif column == "crc_errors":
        assert counters.tolist() == [[0, 2, converted - 5]]
    else:  # the row stays last in ts order
        assert counters.tolist() == [[0, 2, 4]]


def test_a_link_name_that_is_not_utf8_raises_operational_error(tmp_path):
    path = _loose_db(tmp_path / "h.db", GOOD_ROWS)
    conn = sqlite3.connect(path)
    conn.execute(f"UPDATE {TABLE} SET link=CAST(X'ff61' AS TEXT) WHERE rowid=2")
    conn.commit()
    conn.close()
    with pytest.raises(sqlite3.OperationalError, match="Could not decode to UTF-8 column 'link'"):
        torch_fs.load_fleet_history([path], window_seconds=3600, now=NOW)


def _not_a_db(tmp_path):
    path = tmp_path / "notes.db"
    path.write_text("not a database " * 100)
    return path


def _zero_bytes(tmp_path):
    path = tmp_path / "zero.db"
    path.write_bytes(b"")
    return path


@pytest.mark.parametrize("make, exc, message", [
    (lambda tmp: tmp / "missing.db", sqlite3.OperationalError, "unable to open database file"),
    (_not_a_db, sqlite3.DatabaseError, "file is not a database"),
    # SQLite takes an empty file for an empty DB: no tombstones, no table
    (_zero_bytes, sqlite3.OperationalError, f"no such table: {TABLE}"),
], ids=["missing", "not_a_db", "zero_bytes"])
def test_a_db_that_cannot_be_read_raises_sqlite3_s_class(tmp_path, make, exc, message):
    path = make(tmp_path)
    with pytest.raises(exc) as err:
        torch_fs.load_fleet_history([str(path)], window_seconds=3600, now=NOW)
    assert type(err.value) is exc and str(err.value) == message


def _uri(path):
    return f"file:{quote(os.path.abspath(path))}?mode=ro"


def _oracle(path, start):
    """A plain ``sqlite3`` reader of what the native reader reads: the
    tombstones (or the class and message of their read's failure), the link
    names in the order first fetched and the four columns."""
    conn = sqlite3.connect(_uri(path), uri=True)
    try:
        try:
            tombstones = dict(conn.execute(TOMBSTONE_QUERY))
        except sqlite3.Error as e:
            tombstones = (type(e), str(e))
        rows = conn.execute(QUERY, (start,)).fetchall()
    finally:
        conn.close()
    ids = {}
    lid = [ids.setdefault(link, len(ids)) for link, *_r in rows]
    # each column converted as the Python loader converted its batches
    return tombstones, list(ids), [np.array(lid, np.int32)] + [
        np.fromiter((r[k] for r in rows), dtype, len(rows))
        for k, dtype in ((1, np.float64), (2, np.int8), (3, np.int64))]


def _read(path, start, max_samples=torch_fs.MAX_STEPS):
    """The same through the native reader: the tombstones, and the DB's
    :class:`snapshot_reader.Read`, its block walked on this thread."""
    with snapshot_reader.SnapshotDB(_uri(path)) as db:
        try:
            tombstones = db.tombstones()
        except sqlite3.Error as e:
            tombstones = (type(e), str(e))
    with snapshot_reader.Reads([_uri(path)], ["h"], start, max_samples, 0) as reads:
        return tombstones, reads.take(0)


def _seeded(tmp_path):
    # a day of 36 links; tombstones on one link and on the whole host
    path = _host_db(tmp_path / "h.db", links=36, minutes=24 * 60, seed=3)
    db = DB(path)
    NVLinkStore(db).set_tombstone("gpu1/nvlink4", NOW - 1800)
    NVLinkStore(db).set_tombstone("*", NOW - 7200)
    db.close()
    return path


def _window_edge(tmp_path):
    # a sample exactly on the window's start is in it; one a hair before is not
    start = NOW - 3600
    return _loose_db(tmp_path / "h.db", [
        (np.nextafter(start, 0), "gpu0/nvlink0", 0, 1), (start, "gpu0/nvlink1", 1, 2),
        (start, "gpu0/nvlink0", 1, 3), (np.nextafter(start, NOW), "gpu0/nvlink1", 0, 4),
        (NOW - 60.25, "gpu0/nvlink1", 0, 5)])


def _values_to_convert(tmp_path):
    # values the C side hands back to NumPy, among rows it converts itself:
    # the edges of int8, an INTEGER time, REAL states and CRCs, numerals as
    # TEXT and BLOB, a CRC past 32 bits
    return _loose_db(tmp_path / "h.db", [
        (NOW - 600.5, "gpu0/nvlink0", -128, 2**62), (int(NOW) - 500, "gpu0/nvlink1", 127, -7),
        (NOW - 400.75, "gpu0/nvlink0", 1.9, 8.7), (NOW - 300, "gpu0/nvlink1", "0", b"12"),
        (NOW - 200, "gpu0/nvlink0", -1.5, "-3"), (NOW - 100, "gpu0/nvlink1", 1, 2**40 + 0.5),
        ("1699999990.5", "gpu0/nvlink0", b"1", 4)])


def _link_before_the_window(tmp_path):
    # gpu0/nvlink2 has rows, all before the window
    return _loose_db(tmp_path / "h.db", [
        (NOW - 7200, "gpu0/nvlink2", 1, 1), (NOW - 60, "gpu0/nvlink0", 1, 2),
        (NOW - 30, "gpu0/nvlink1", 1, 3), (NOW - 5000, "gpu0/nvlink2", 0, 4)])


def _empty(tmp_path):
    db = DB(str(tmp_path / "h.db"))
    NVLinkStore(db)
    db.close()
    return str(tmp_path / "h.db")


def _no_tombstone_table(tmp_path):
    return _loose_db(tmp_path / "h.db", GOOD_ROWS)


def _uri_syntax_in_the_path(tmp_path):
    d = tmp_path / "a?b#c%20d"
    d.mkdir()
    return _host_db(d / "h%3F?#.db", links=18, minutes=90, seed=5)


def _wide_names(tmp_path):
    # more names than the reader's first table holds, some of them long,
    # one empty, one not ASCII
    names = ["", "gpu0/nvlink\u00e9"] + [f"link-{k:04d}" * (1 + k % 9) for k in range(600)]
    return _loose_db(tmp_path / "h.db", [
        (NOW - 3000 + k, names[k * 7 % len(names)], k % 2, k) for k in range(5000)])


@pytest.mark.parametrize("make", [_seeded, _window_edge, _values_to_convert,
                                  _link_before_the_window, _empty, _no_tombstone_table,
                                  _uri_syntax_in_the_path, _wide_names])
def test_the_reader_reads_what_sqlite3_reads(tmp_path, make):
    path = make(tmp_path)
    start = NOW - 3600
    want_tombstones, want_names, want = _oracle(path, start)
    tombstones, read = _read(path, start)
    assert tombstones == want_tombstones and read.block.names == want_names
    assert read.fetched == len(want[0])
    if make is _no_tombstone_table:
        assert tombstones == (sqlite3.OperationalError,
                              f"no such table: {torch_fs.TOMBSTONE_TABLE}")


@pytest.mark.parametrize("make", [lambda tmp: tmp / "missing.db", _not_a_db],
                         ids=["missing", "not_a_db"])
def test_the_reader_raises_what_sqlite3_raises(tmp_path, make):
    path = make(tmp_path)
    with pytest.raises(sqlite3.Error) as want:
        _oracle(path, NOW - 3600)
    with pytest.raises(sqlite3.Error) as got:
        _read(path, NOW - 3600)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert got.value.sqlite_errorcode == want.value.sqlite_errorcode


def test_a_link_name_that_is_not_text_raises_type_error(tmp_path):
    path = _loose_db(tmp_path / "h.db", _with("link", b"gpu0/nvlink0"))
    with pytest.raises(TypeError, match="SQLite type BLOB"):
        _read(path, NOW - 3600)


def test_the_reader_runs_on_the_interpreter_s_sqlite():
    assert snapshot_reader.sqlite_version() == sqlite3.sqlite_version
    assert Path(snapshot_reader.sqlite_library()).name.startswith("libsqlite3.so")


def test_the_reader_builds_in_the_first_load_and_not_at_import(tmp_path):
    # a clean build dir: importing the loader compiles nothing, its first
    # call compiles the reader once, under the name its sources hash to
    db = _host_db(tmp_path / "h.db", links=18, minutes=10)
    code = textwrap.dedent(f"""
        import json, subprocess, sys
        from pathlib import Path
        calls, real = [], subprocess.run
        def run(cmd, *a, **k):
            calls.append(Path(cmd[0]).name)
            return real(cmd, *a, **k)
        subprocess.run = run
        from gpud_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path / "build")!r})
        from gpud_tpu_torch import fleet_scan, snapshot_reader
        listing = lambda: sorted(p.name for p in _build.BUILD_DIR.glob("*"))
        before = [list(calls), listing()]
        names, *_rest = fleet_scan.load_fleet_history([{db!r}], 3600, now={NOW!r})
        fleet_scan.load_fleet_history([{db!r}], 3600, now={NOW!r})
        want = _build.host_library_path((snapshot_reader.sqlite_library(),)).name
        print(json.dumps([before, calls, listing(), want, len(names)]))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    before, calls, listing, want, n_links = json.loads(proc.stdout)
    assert before == [[], []]
    assert calls == ["cc"] and listing == [want] and n_links == 18


def test_the_reader_s_name_changes_with_its_source_and_flags(tmp_path, monkeypatch):
    for src in (REPO / "gpud_tpu_torch" / "csrc").glob("*.c"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    name = _build.host_library_path(("/lib/libsqlite3.so.0",))
    assert name == _build.host_library_path(("/lib/libsqlite3.so.0",))
    assert name != _build.host_library_path(("/usr/local/lib/libsqlite3.so.0",))
    assert name.name.startswith("libgpud_tpu_torch_host_")
    src = next(tmp_path.glob("*.c"))
    src.write_text(src.read_text() + "\n/* changed */\n")
    assert _build.host_library_path(("/lib/libsqlite3.so.0",)) != name
    assert _build.library_path().name.startswith("libgpud_tpu_torch_")  # the kernels' apart


# The loader reads the DBs on worker threads, as many as the cores it may
# use (os.sched_getaffinity), and consumes them in DB order: W is forced
# here through that call alone
W = 4
DATA_MAKERS = [_seeded, _window_edge, _values_to_convert, _link_before_the_window,
               _empty, _no_tombstone_table, _wide_names]


def _cores(monkeypatch, n):
    monkeypatch.setattr(os, "sched_getaffinity", lambda _pid: set(range(n)))


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    """One DB file a maker, written once and copied into each DB set."""
    out = {}
    for make in DATA_MAKERS:
        d = tmp_path_factory.mktemp(make.__name__)
        out[make.__name__] = make(d)
    return out


def _distinct(i):
    return f"host{i}"


def _duplicate_stems(i):
    # every DB named h.db in its own directory: hosts h, h-2, h-3, ...
    return "h"


def _two_db_host(i):
    # an odd DB takes the name that the next h.db is given: the two share a
    # host, one block over both, the odd one's links first
    return "h" if i % 2 == 0 else f"h-{i // 2 + 2}"


def _db_set(tmp_path, templates, first, n, stem=_distinct):
    """``n`` DBs, each in a directory of its own, their data cycling over
    the makers from ``first``."""
    names = [m.__name__ for m in DATA_MAKERS]
    k0 = names.index(first)
    paths = []
    for i in range(n):
        d = tmp_path / f"d{i}"
        d.mkdir()
        paths.append(str(d / f"{stem(i)}.db"))
        shutil.copy(templates[names[(k0 + i) % len(names)]], paths[-1])
    return paths


def _load(paths, monkeypatch, cores, window=3600, **kw):
    _cores(monkeypatch, cores)
    DEFAULT_TRACER.clear()
    out = torch_fs.load_fleet_history(paths, window_seconds=window, now=NOW, **kw)
    load = next(s for s in DEFAULT_TRACER.snapshot(component=torch_fs.COMPONENT)
                if s["name"] == "fleet_scan.load")
    return out, load["attrs"]


def _assert_same_load(got, want):
    assert got[0] == want[0] and got[4] == want[4]
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


DB_COUNTS = [1, 2, W - 1, W, W + 1, 3 * W + 1]
SETS = [(m.__name__, _distinct) for m in DATA_MAKERS if m is not _empty] + [
    ("_seeded", _duplicate_stems), ("_window_edge", _two_db_host)]


@pytest.mark.parametrize("n", DB_COUNTS)
@pytest.mark.parametrize("first, stem", SETS,
                         ids=[f"{f}{'' if s is _distinct else s.__name__}" for f, s in SETS])
@pytest.mark.parametrize("max_samples", [torch_fs.MAX_STEPS, 2], ids=["whole", "cut"])
def test_workers_load_what_the_inline_read_loads(tmp_path, templates, monkeypatch, first,
                                                 stem, n, max_samples):
    paths = _db_set(tmp_path, templates, first, n, stem)
    want, inline = _load(paths, monkeypatch, 1, max_samples=max_samples)
    got, attrs = _load(paths, monkeypatch, W, max_samples=max_samples)
    _assert_same_load(got, want)
    assert inline["workers"] == "0" and attrs["workers"] == str(min(W, n) if n > 1 else 0)
    assert {k: attrs[k] for k in ("rows_fetched", "rows_tombstoned", "rows_kept")} == {
        k: inline[k] for k in ("rows_fetched", "rows_tombstoned", "rows_kept")}


def _readers():
    """This process's native reader threads, by name."""
    names = []
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/comm") as f:
                names.append(f.read().strip())
        except OSError:
            pass  # a thread that ended while listed
    return [n for n in names if n == "fleet_scan-read"]


def _db_fds(paths):
    """This process's descriptors open on any of ``paths``."""
    targets = {os.path.realpath(p) for p in paths}
    fds = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            if os.path.realpath(os.readlink(f"/proc/self/fd/{fd}")) in targets:
                fds.append(fd)
        except OSError:
            pass
    return fds


def _no_table(tmp_path):
    # a DB that opens and has tombstones, but no snapshot table: the walk's
    # prepare fails
    path = tmp_path / "no_table.db"
    conn = sqlite3.connect(path)
    conn.execute(f"CREATE TABLE {torch_fs.TOMBSTONE_TABLE} (link TEXT PRIMARY KEY, ts REAL)")
    conn.execute(f"INSERT INTO {torch_fs.TOMBSTONE_TABLE} VALUES ('*', ?)", (NOW - 60,))
    conn.commit()
    conn.close()
    return path


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("make, exc, message", [
    (lambda tmp: tmp / "missing.db", sqlite3.OperationalError, "unable to open database file"),
    (_not_a_db, sqlite3.DatabaseError, "file is not a database"),
    (_no_table, sqlite3.OperationalError, f"no such table: {TABLE}"),
], ids=["missing", "not_a_db", "no_table"])
def test_a_failing_db_raises_as_it_did_and_leaves_nothing_running(
        tmp_path, templates, monkeypatch, where, make, exc, message):
    paths = _db_set(tmp_path, templates, "_seeded", 3 * W + 1)
    bad_dir = tmp_path / "bad"
    bad_dir.mkdir()
    bad = str(make(bad_dir))
    at = {"first": 0, "middle": len(paths) // 2, "last": len(paths)}[where]
    paths.insert(at, bad)
    # a day of 36 links a DB: the reads after the failing DB are still
    # walking when it is taken
    _cores(monkeypatch, W)
    raised = []

    def load():
        try:
            torch_fs.load_fleet_history(paths, window_seconds=3600, now=NOW)
        except Exception as e:  # the test's thread hands the failure back
            raised.append(e)

    t = threading.Thread(target=load)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the load hung"
    assert len(raised) == 1 and type(raised[0]) is exc and str(raised[0]) == message
    assert _readers() == [] and _db_fds(paths) == []


def _clipped_cut(tmp_path):
    # counters that leave int32 against a link's first sample: before the
    # cut (l0), among the kept samples (l1), on a link of two samples (l2)
    rows = []
    for i in range(40):
        rows.append((NOW - 3000 + 60 * i, "l0", i % 2, 0 if i == 0 else 2**40 + 7 * i))
        rows.append((NOW - 2999 + 60 * i, "l1", 1, 3 * i + (2**35 if i % 3 == 2 else 0)))
    rows += [(NOW - 100, "l2", 1, -(2**40)), (NOW - 50, "l2", 0, 5)]
    return _loose_db(tmp_path / "h.db", rows)


def _reference_block(path, start, max_samples, make):
    """Each link's kept (states, counters), by name, and the names cut: the
    reference loader's, or where only NumPy's conversion reads the values
    (_values_to_convert, which has no tombstones) _oracle's columns, each
    link's latest ``max_samples`` rebased on the first as NumPy does."""
    if make is _values_to_convert:
        _t, names, (lid, _ts, state, crc) = _oracle(path, start)
        rows = [np.flatnonzero(lid == k) for k in range(len(names))]
        return ({name: (state[r[-max_samples:]],
                        np.clip(crc[r[-max_samples:]] - crc[r[-max_samples:]][0],
                                -(2**31), 2**31 - 1).astype(np.int32))
                 for name, r in zip(names, rows)},
                {name for name, r in zip(names, rows) if len(r) > max_samples})
    host = os.path.splitext(os.path.basename(path))[0]
    names, states, counters, valid, cut = jax_fs.load_fleet_history(
        [path], window_seconds=NOW - start, now=NOW, max_samples=max_samples)
    return ({name[len(host) + 1:]: (s[v], c[v])
             for name, s, c, v in zip(names, states, counters, valid)},
            {name[len(host) + 1:] for name in cut})


@pytest.mark.parametrize("max_samples", [torch_fs.MAX_STEPS, 30, 2, 1])
@pytest.mark.parametrize("make", DATA_MAKERS + [_uri_syntax_in_the_path, _clipped_cut])
def test_the_block_call_gives_the_column_path_s_block(tmp_path, make, max_samples):
    # one DB's block, its links in the order first fetched, against the
    # reference's arrays of the same DB
    path = make(tmp_path)
    start = NOW - 3600
    want, want_cut = _reference_block(path, start, max_samples, make)
    _tombstones, names, (lid, *_columns) = _oracle(path, start)
    read = _read(path, start, max_samples)[1]
    block = read.block
    assert block.names == names and read.links == [names[k] for k in np.flatnonzero(block.kept)]
    assert (read.fetched, read.tombstoned) == (len(lid), len(lid) - int(block.kept.sum()))
    assert set(read.links) == set(want)
    assert {names[k] for k in np.flatnonzero(block.kept > max_samples)} == want_cut
    assert block.states.dtype == np.int8 and block.counters.dtype == np.int32
    assert block.states.shape[1] == max((len(s) for s, _c in want.values()), default=0)
    for k, name in enumerate(names):
        n = min(int(block.kept[k]), max_samples)
        assert block.valid[k].tolist() == [True] * n + [False] * (block.valid.shape[1] - n)
        got = (block.states[k, :n], block.counters[k, :n])
        assert all(np.array_equal(g, w) for g, w in zip(got, want.get(name, ((), ())))), name
        assert not block.states[k, n:].any() and not block.counters[k, n:].any()


@pytest.mark.parametrize("link, exc", [("gone", None), ("gpu1/nvlink4", TypeError)])
def test_a_tombstone_that_is_no_number_is_still_walked_into_a_block(tmp_path, monkeypatch,
                                                                     link, exc):
    # a TEXT floor: the tombstones are judged in Python and the DB walked
    # into its block as any other. On a link without rows it changes
    # nothing; on a link with rows it raises after the walk what the
    # loader's floor expression raises
    path = _seeded(tmp_path)
    other = _host_db(tmp_path / "g.db", 18, 90)
    want, _attrs = _load([path, other], monkeypatch, W)
    conn = sqlite3.connect(path)
    conn.execute(f"INSERT OR REPLACE INTO {torch_fs.TOMBSTONE_TABLE} (link, ts) "
                 "VALUES (?, 'abc')", (link,))
    conn.commit()
    conn.close()
    if exc is None:
        got, _attrs = _load([path, other], monkeypatch, W)
        _assert_same_load(got, want)
        assert len(got[0]) == 36 + 18 and got[4] == []
        return
    with pytest.raises(exc) as err:
        _load([path, other], monkeypatch, W)
    assert str(err.value) == "'>' not supported between instances of 'str' and 'float'"


def test_max_samples_below_one_raises_before_any_db_is_opened(tmp_path):
    with pytest.raises(ValueError, match="max_samples must be at least 1, not 0"):
        torch_fs.load_fleet_history([str(tmp_path / "missing.db")], 3600, now=NOW,
                                    max_samples=0)


def test_workers_grow_blocks_past_their_first_size(tmp_path, monkeypatch):
    # 300 links of 150 samples: more than the first block's 256 rows and 64
    # samples, so the first DBs' blocks grow on the workers, and the later
    # DBs start at the size the first ones reached; one host is smaller than
    # the rest
    paths = [_host_db(tmp_path / f"host{i}.db", links=300 if i != 5 else 200,
                      minutes=150 if i != 5 else 90, seed=i)
             for i in range(2 * W + 1)]
    want, _inline = _load(paths, monkeypatch, 1, window=150 * 60)
    got, attrs = _load(paths, monkeypatch, W, window=150 * 60)
    _assert_same_load(got, want)
    assert attrs["workers"] == str(W)
    assert got[1].shape == (2 * W * 300 + 200, 150)


ARENAS = """
import ctypes, glob, io, os, sys
sys.path.insert(0, {repo!r})
os.sched_getaffinity = lambda _pid: set(range({w}))
import gpud_tpu_torch.fleet_scan as fs

def arenas():
    # glibc's malloc_stats prints one "Arena n:" line an arena on stderr
    r, w = os.pipe()
    saved = os.dup(2)
    os.dup2(w, 2)
    ctypes.CDLL(None).malloc_stats()
    os.dup2(saved, 2)
    os.close(w)
    return os.read(r, 1 << 20).decode().count("Arena ")

paths = sorted(glob.glob({pattern!r}))
fs.load_fleet_history(paths[:1], 9000, now={now!r})
counts = [arenas()]
for _ in range(3):
    fs.load_fleet_history(paths, 9000, now={now!r})
    counts.append(arenas())
print(*counts)
"""


def test_worker_arenas_do_not_grow_across_loads(tmp_path):
    # each worker allocates for itself, from a malloc arena of its own: the
    # first load with workers adds at most one a worker, and the next loads'
    # workers take those arenas again, so the process keeps no more of them
    import platform

    if platform.libc_ver()[0] != "glibc":
        pytest.skip("counts glibc's malloc arenas")
    for i in range(2 * W + 1):
        _host_db(tmp_path / f"host{i}.db", links=300, minutes=150, seed=i)
    code = ARENAS.format(repo=str(REPO), w=W, pattern=str(tmp_path / "host*.db"), now=NOW)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    inline, first, *later = map(int, proc.stdout.split())
    assert inline <= first <= inline + W
    assert later == [first, first]


@pytest.mark.parametrize("n, cores", [(1, W), (5, 1), (5, 2), (5, W), (2 * W + 1, W),
                                      (8 * W + 1, 8 * W)])
def test_opens_on_workers_counts_the_dbs_opened_on_a_worker(tmp_path, templates, monkeypatch,
                                                           n, cores):
    # with two workers or more every DB is opened on one, the DB after a
    # host's first too; read inline (one core, or one DB), none is. The last
    # case runs more workers than most hosts have cores
    paths = _db_set(tmp_path, templates, "_seeded", n, _two_db_host)
    want, _inline = _load(paths, monkeypatch, 1)
    got, attrs = _load(paths, monkeypatch, cores)
    _assert_same_load(got, want)
    workers = min(cores, n) if min(cores, n) > 1 else 0
    assert attrs["workers"] == str(workers)
    assert attrs["opens_on_workers"] == str(n if workers else 0)
