"""Parity of the port's write-behind storage (gpud_tpu_torch/storage/) and
the rest of its metrics pipeline (metrics/store.py: Syncer,
SelfMetricsRecorder) with gpud_tpu's.

Every case runs the same ops on a writer of each package, each over its own
state DB, and compares the tables after ``flush()`` row for row and the
writers' accounting (commits, committed, coalesced into place, dropped).
The cases of the reference's tests/test_storage_writer.py,
test_storage_edges.py and test_metrics_pipeline.py; scheduler-driven drains
run on an injected clock, and no case sleeps."""

import threading

import numpy as np
import pytest

from torch_daemon_parity import IDS, PKGS, PORT, REF, Clock, rows, schema

SQL = "INSERT INTO t (k, v) VALUES (?, ?)"
SQL2 = "INSERT INTO t (k, v) VALUES (?, 'x')"
WAIT = 10.0
ACCOUNTING = ("pending_ops", "commits", "committed_ops", "dropped_ops", "last_batch_ops")


def open_db(pkg, path):
    db = pkg.sqlite.DB(str(path))
    db.execute("CREATE TABLE t (k TEXT, v TEXT)")
    return db


def table(db):
    return db.query("SELECT k, v FROM t ORDER BY rowid")


def accounting(w):
    st = w.stats()
    return {k: st[k] for k in ACCOUNTING}


def both(tmp_path, scenario):
    """Run ``scenario(pkg, db)`` on each package; returns {name: result}."""
    out = {}
    for pkg in PKGS:
        db = open_db(pkg, tmp_path / f"{pkg.name}.state")
        try:
            out[pkg.name] = scenario(pkg, db)
        finally:
            db.close()
    return out


def assert_same(tmp_path, scenario, expected=None):
    got = both(tmp_path, scenario)
    assert got["port"] == got["ref"]
    if expected is not None:
        assert got["port"] == expected
    return got["port"]


def scheduler(pkg, clock, workers=2):
    s = pkg.scheduler.Scheduler(workers=workers)
    s.time_fn = clock
    s.start()
    return s


def wait_committed(w, n):
    with w._cv:
        ok = w._cv.wait_for(lambda: w._committed_ops >= n, WAIT)
    assert ok, f"{n} ops never committed"


# -- the contract, clause by clause -------------------------------------------------

def test_nothing_visible_before_drain_everything_after(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        acc = [w.submit("events", SQL, (f"k{i}", "v")) for i in range(10)]
        before = (table(db), w.pending_ops())
        drained = w.drain()
        out = (acc, before, drained, table(db), accounting(w))
        w.close()
        return out
    out = assert_same(tmp_path, run)
    assert out[1] == ([], 10) and len(out[3]) == 10


def test_flush_barrier_gives_read_your_writes(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        w.submit("events", SQL, ("a", "1"))
        first = w.flush(timeout=WAIT)
        out = (first, table(db), w.flush(timeout=WAIT), accounting(w))
        w.close()
        return out
    assert assert_same(tmp_path, run)[1] == [("a", "1")]


def test_keyed_ops_coalesce_last_write_wins(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        for i in range(100):
            w.submit("metrics", SQL, ("gauge", f"v{i}"), key=("m", "gauge"))
        w.submit("metrics", SQL, ("a", "1"), key=("m", "a"))
        w.submit("ledger", SQL, ("a", "2"), key=("hl", "a"))  # another namespace
        pending = w.pending_ops()
        w.drain()
        out = (pending, table(db), accounting(w))
        w.close()
        return out
    out = assert_same(tmp_path, run)
    assert out[0] == 3 and out[1] == [("gauge", "v99"), ("a", "1"), ("a", "2")]


def test_submit_many_groups_sql_in_one_transaction(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        n = w.submit_many("events", SQL, [("a", "1"), ("b", "2")])
        w.submit("audit", SQL2, ("c",))
        w.submit_many("events", SQL, [])
        w.submit_many("metrics", SQL, [("k1", "1"), ("k2", "2")], keys=[("m", 1), ("m", 2)])
        w.drain()
        out = (n, table(db), accounting(w))
        w.close()
        return out
    assert assert_same(tmp_path, run)[2]["commits"] == 1


def test_bounded_queue_drops_overflow_and_counts(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db, max_pending=1000, backpressure_seconds=0.0)
        accepted = sum(w.submit_many("events", SQL, [(f"k{i}", "v")]) for i in range(1500))
        w.submit("metrics", SQL, ("late", "v"), key=("m", "late"))  # no room: dropped too
        acc = accounting(w)
        w.drain()
        out = (accepted, acc, len(table(db)), accounting(w))
        w.close()
        return out
    out = assert_same(tmp_path, run)
    assert out[0] == 1000 and out[1]["dropped_ops"] == 501


def test_backpressure_waits_for_the_flush_job(tmp_path):
    def run(pkg, db):
        clock = Clock()
        s = scheduler(pkg, clock)
        w = pkg.writer.BatchWriter(db, max_pending=1000, backpressure_seconds=WAIT)
        try:
            w.start(s)
            w.submit_many("events", SQL, [(f"k{i}", "v") for i in range(1000)])
            # full: this submit pokes the flush job and waits for its drain
            landed = w.submit("events", SQL, ("late", "v"))
            assert w.flush(timeout=WAIT)
            return (landed, len(table(db)), ("late", "v") in table(db),
                    w.stats()["dropped_ops"], pkg.writer.FLUSH_JOB_NAME in s.job_names())
        finally:
            w.close()
            s.close()
    assert assert_same(tmp_path, run) == (True, 1001, True, 0, True)


def test_the_flush_job_drains_on_its_interval(tmp_path):
    def run(pkg, db):
        clock = Clock()
        s = scheduler(pkg, clock)
        w = pkg.writer.BatchWriter(db, flush_interval_seconds=0.2)
        try:
            w.start(s)
            job = s.get_job(pkg.writer.FLUSH_JOB_NAME)
            first_due = job.due
            w.submit("events", SQL, ("tick", "v"))
            clock.advance(0.2)  # the job's deadline, without jitter
            with s._cv:
                s._cv.notify_all()
            wait_committed(w, 1)  # no barrier involved
            return (first_due, table(db))
        finally:
            w.close()
            s.close()
    assert assert_same(tmp_path, run) == (1000.2, [("tick", "v")])


def test_the_threshold_pokes_an_early_drain(tmp_path):
    def run(pkg, db):
        clock = Clock()
        s = scheduler(pkg, clock)
        # the interval is an hour of the injected clock: only the poke drains
        w = pkg.writer.BatchWriter(db, flush_interval_seconds=3600.0, flush_threshold=50)
        try:
            w.start(s)
            w.submit_many("events", SQL, [(f"k{i}", "v") for i in range(49)])
            below = w.pending_ops()
            w.submit("events", SQL, ("k49", "v"))
            wait_committed(w, 50)
            return (below, len(table(db)))
        finally:
            w.close()
            s.close()
    assert assert_same(tmp_path, run) == (49, 50)


def test_a_barrier_drains_inline_without_workers(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        w.submit("events", SQL, ("solo", "v"))
        done = []
        th = threading.Thread(target=lambda: done.append(w.flush(timeout=WAIT)))
        th.start()
        th.join(timeout=WAIT)
        out = (th.is_alive(), done, table(db))
        w.close()
        return out
    assert assert_same(tmp_path, run) == (False, [True], [("solo", "v")])


def test_close_flushes_then_falls_back_to_synchronous(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        w.submit("events", SQL, ("pre", "v"))
        w.close()
        after_close = table(db)
        sync = (w.submit("events", SQL, ("post", "v")),
                w.submit_many("events", SQL, [("post2", "v"), ("post3", "v")]))
        w.close()  # twice is a no-op
        return (after_close, sync, table(db), accounting(w))
    out = assert_same(tmp_path, run)
    assert out[0] == [("pre", "v")] and len(out[2]) == 4


def test_drop_pending_discards_and_releases_barriers(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        w.submit_many("events", SQL, [("doomed", "v"), ("doomed2", "v")])
        w.submit("metrics", SQL, ("g", "1"), key=("m", "g"))
        n = w.drop_pending(reason="crash")
        out = (n, w.pending_ops(), w.flush(timeout=1.0), table(db), accounting(w))
        w.close()
        return out
    assert assert_same(tmp_path, run)[:4] == (3, 0, True, [])


def test_a_failed_commit_drops_the_batch_and_advances_the_watermark(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        w.submit("events", "INSERT INTO missing_table VALUES (?)", ("x",))
        w.submit("events", SQL, ("ok", "v"))
        w.drain()  # atomic: neither group lands
        out = (table(db), accounting(w), w.flush(timeout=1.0))
        w.submit("events", SQL, ("next", "v"))
        w.drain()
        out += (table(db), accounting(w))
        w.close()
        return out
    out = assert_same(tmp_path, run)
    assert out[0] == [] and out[1]["dropped_ops"] == 2 and out[3] == [("next", "v")]


def test_concurrent_producers_all_land(tmp_path):
    def run(pkg, db):
        clock = Clock()
        s = scheduler(pkg, clock)
        w = pkg.writer.BatchWriter(db, flush_threshold=100)
        try:
            w.start(s)
            threads = [threading.Thread(target=lambda t=t: [
                w.submit("events", SQL, (f"t{t}-{i}", "v")) for i in range(200)]) for t in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=WAIT)
            assert not any(th.is_alive() for th in threads)
            assert w.flush(timeout=WAIT)
            return (sorted(table(db)), w.stats()["dropped_ops"], w.stats()["committed_ops"])
        finally:
            w.close()
            s.close()
    out = assert_same(tmp_path, run)
    assert len(out[0]) == 800 and out[1:] == (0, 800)


def test_checkpoint_wal_truncates_and_samples(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db)
        w.submit_many("events", SQL, [(f"k{i}", "v" * 100) for i in range(2000)])
        info = pkg.writer.checkpoint_wal(db, writer=w)
        out = (sorted(info), info["busy"], info["wal_bytes"] > 0, db.wal_size_bytes(),
               len(table(db)), pkg.writer._g_wal_bytes.get() == info["wal_bytes"])
        w.close()
        return out
    assert assert_same(tmp_path, run) == (
        ["busy", "checkpointed_pages", "log_pages", "seconds", "wal_bytes"], 0, True, 0, 2000, True)


def test_checkpoint_wal_in_memory_is_a_no_op():
    for pkg in PKGS:
        db = pkg.sqlite.DB(":memory:")
        info = pkg.writer.checkpoint_wal(db)
        assert (info["wal_bytes"], info["busy"], info["log_pages"]) == (0, 0, -1)


def test_fsync_batches_commit_and_restore_normal_sync(tmp_path):
    def run(pkg, db):
        w = pkg.writer.BatchWriter(db, fsync=True)
        w.submit("events", SQL, ("durable", "v"))
        w.drain()
        out = (table(db), db.query("PRAGMA synchronous")[0][0])
        w.close()
        return out
    assert assert_same(tmp_path, run) == ([("durable", "v")], 1)


@pytest.mark.parametrize("seed", range(8))
def test_a_seeded_op_stream_commits_the_same_rows(tmp_path, seed):
    """Random appends, keyed upserts, batches, drains and barriers across
    three statements: the same stream gives the same table and accounting."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(600):
        kind = rng.choice(["append", "keyed", "many", "drain", "flush"], p=[.4, .3, .2, .05, .05])
        k, v = f"k{int(rng.integers(0, 40))}", f"v{i}"
        sql = [SQL, SQL2, "INSERT INTO t (k, v) VALUES (?, upper(?))"][int(rng.integers(0, 3))]
        ops.append((kind, sql, k, v))

    def run(pkg, db):
        w = pkg.writer.BatchWriter(db, max_pending=1000, backpressure_seconds=0.0)
        for kind, sql, k, v in ops:
            params = (k,) if sql == SQL2 else (k, v)
            if kind == "append":
                w.submit("events", sql, params)
            elif kind == "keyed":
                w.submit("ledger", sql, params, key=("hl", k))
            elif kind == "many":
                w.submit_many("metrics", sql, [params, params], keys=[("m", k, 0), ("m", k, 1)])
            elif kind == "drain":
                w.drain()
            else:
                w.flush(timeout=WAIT)
        w.flush(timeout=WAIT)
        out = (table(db), accounting(w))
        w.close()
        return out
    assert_same(tmp_path, run)


def test_the_writer_s_metrics_have_the_reference_s_names():
    for attr in ("_g_queue_depth", "_g_batch_size", "_h_flush", "_c_ops", "_c_coalesced",
                 "_c_dropped", "_c_commits", "_c_backpressure", "_g_wal_bytes", "_h_checkpoint"):
        r, p = getattr(REF.writer, attr), getattr(PORT.writer, attr)
        assert (p.name, p.help_text) == (r.name, r.help_text), attr
    for name in ("DEFAULT_FLUSH_INTERVAL", "DEFAULT_MAX_PENDING", "DEFAULT_FLUSH_THRESHOLD",
                 "DEFAULT_BACKPRESSURE_SECONDS", "FLUSH_JOB_NAME"):
        assert getattr(PORT.writer, name) == getattr(REF.writer, name), name


# -- metrics pipeline: store, syncer, self-metrics recorder ---------------------------

def test_the_metrics_table_is_the_reference_s(tmp_path):
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        pkg.metrics_store.MetricsStore(db)
        got[pkg.name] = schema(db)
        db.close()
    assert got["port"] == got["ref"] and "tpud_metrics_v0_1" in got["port"]


@pytest.mark.parametrize("with_writer", [False, True], ids=["sync", "writer"])
def test_the_syncer_writes_and_purges_the_reference_s_rows(tmp_path, with_writer):
    def run(pkg, db):
        reg = pkg.registry.Registry()
        g = reg.gauge("sync_metric", "h")
        c = reg.counter("sync_total", "h")
        hist = reg.histogram("sync_seconds", "h", buckets=(0.1, 1.0))
        w = pkg.writer.BatchWriter(db) if with_writer else None
        store = pkg.metrics_store.MetricsStore(db, retention_seconds=3600, writer=w)
        sy = pkg.metrics_store.Syncer(registry=reg, store=store, interval_seconds=60)
        clock = Clock(1_700_000_000.0)
        sy.time_now_fn = clock
        counts = []
        for step, value in enumerate([1.0, 2.0, 2.0, 3.0]):
            g.set(value, {"component": "accelerator-gpu-temperature", "gpu": str(step % 2)})
            c.inc(labels={"component": "cpu"})
            hist.observe(0.05 * step)
            counts.append(sy.sync_once())
            clock.advance(60 if step < 2 else 3600)  # the last step ages the first out
        store.flush()
        out = (counts, rows(db, "tpud_metrics_v0_1"),
               [m.to_dict() for m in store.read(0, components=["accelerator-gpu-temperature"])])
        if w is not None:
            w.close()
        return out
    out = assert_same(tmp_path, run)
    assert out[0][0] >= 3 and out[1]


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_the_syncer_and_recorder_run_as_scheduler_jobs(pkg, tmp_path):
    clock = Clock()
    s = pkg.scheduler.Scheduler(workers=2)
    s.time_fn = clock
    db = open_db(pkg, tmp_path / "s.state")
    reg = pkg.registry.Registry()
    store = pkg.metrics_store.MetricsStore(db)
    sy = pkg.metrics_store.Syncer(reg, store, interval_seconds=2)
    rec = pkg.metrics_store.SelfMetricsRecorder(reg, db, interval_seconds=900)
    try:
        sy.start(s)
        rec.start(s)
        sy.start(s)  # idempotent
        assert s.job_names() == ["metrics-syncer", "self-metrics-recorder"]
        assert s.get_job("metrics-syncer").due == 1002.0  # scrape-at-boot skipped
        assert s.get_job("self-metrics-recorder").startup
        s.start()
        assert s.wait_first_runs(timeout=WAIT) == 0.0
        assert rec.g_fds.get() > 0
    finally:
        sy.close()
        rec.close()
        s.close()
        db.close()
    assert s.job_names() == []


def test_the_recorder_sets_the_reference_s_gauges(tmp_path):
    def run(pkg, db):
        reg = pkg.registry.Registry()
        rec = pkg.metrics_store.SelfMetricsRecorder(reg, db)
        rec.record_once()
        names = sorted((m.name, m.help_text) for m in
                       (rec.g_db_size, rec.g_fds, rec.g_select_secs, rec.g_write_secs,
                        rec.g_vacuum_secs))
        return (names, rec.g_db_size.get() == db.size_bytes(), rec.g_fds.get() > 0)
    assert assert_same(tmp_path, run)[1:] == (True, True)


def test_open_fd_count_is_the_reference_s():
    assert PORT.metrics_store._open_fd_count() > 0
    assert abs(PORT.metrics_store._open_fd_count() - REF.metrics_store._open_fd_count()) <= 1
