"""The port's fleet scan (gpud_tpu_torch/fleet_scan.py) against
gpud_tpu/fleet_scan.py on the same host DBs, written by gpud_tpu's ICIStore
as tests/test_fleet_scan.py writes them. The port runs with device="cpu";
its links, summary and truncated_links must equal the reference's, and
load_fleet_history must give equal arrays."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from gpud_tpu import cli as jax_cli
from gpud_tpu import fleet_scan as jax_fs
from gpud_tpu.components.tpu.ici_store import ICIStore
from gpud_tpu.sqlite import DB
from gpud_tpu.tpu.instance import ICILinkSnapshot, LinkState

from gpud_tpu_torch import cli as torch_cli
from gpud_tpu_torch import fleet_scan as torch_fs

NOW = 1_700_000_000.0
REPO = Path(__file__).resolve().parent.parent


def _mk_host_db(path, down=(), flappy=(), crc_hot=(), n_chips=2, n_links=2,
                now=NOW, minutes=30):
    db = DB(str(path))
    store = ICIStore(db)
    for minute in range(minutes):
        ts = now - (minutes - minute) * 60
        links = []
        for c in range(n_chips):
            for l in range(n_links):
                name = f"chip{c}/ici{l}"
                state = LinkState.UP
                if name in down and minute >= 20:
                    state = LinkState.DOWN
                if name in flappy and minute % 4 < 2:
                    state = LinkState.DOWN
                links.append(ICILinkSnapshot(
                    chip_id=c, link_id=l, state=state,
                    crc_errors=minute * 50 if name in crc_hot else 0,
                ))
        store.insert_snapshot(links, ts=ts)
    return db, store


def _fleet_ab(tmp_path):
    paths = []
    for host, kw in (("hostA", dict(down=("chip0/ici0",))),
                     ("hostB", dict(flappy=("chip1/ici1",))),
                     ("hostC", dict(crc_hot=("chip0/ici1",)))):
        db, _ = _mk_host_db(tmp_path / f"{host}.db", **kw)
        db.close()
        paths.append(str(tmp_path / f"{host}.db"))
    return paths, dict(window_seconds=3600, now=NOW)


def _tombstones(tmp_path):
    # a global tombstone on one host, a per-link one on another
    db, store = _mk_host_db(tmp_path / "g.db", flappy=("chip0/ici0",),
                            down=("chip1/ici1",))
    store.set_tombstone("*", ts=NOW + 1)
    store.insert_snapshot(
        [ICILinkSnapshot(chip_id=c, link_id=l, state=LinkState.UP)
         for c in range(2) for l in range(2)], ts=NOW + 10)
    db.close()
    db, store = _mk_host_db(tmp_path / "p.db", crc_hot=("chip0/ici0",),
                            down=("chip1/ici1",))
    # leaves two samples, 50 CRC errors apart (below the threshold)
    store.set_tombstone("chip0/ici0", ts=NOW - 150)
    db.close()
    return ([str(tmp_path / "g.db"), str(tmp_path / "p.db")],
            dict(window_seconds=3600, now=NOW + 20))


def _same_stem(tmp_path):
    (tmp_path / "rack1").mkdir()
    (tmp_path / "rack2").mkdir()
    _mk_host_db(tmp_path / "rack1" / "host.db")[0].close()
    _mk_host_db(tmp_path / "rack2" / "host.db", down=("chip0/ici0",))[0].close()
    return ([str(tmp_path / "rack1" / "host.db"), str(tmp_path / "rack2" / "host.db")],
            dict(window_seconds=3600, now=NOW))


def _empty_window(tmp_path):
    _mk_host_db(tmp_path / "old.db")[0].close()
    return [str(tmp_path / "old.db")], dict(window_seconds=60, now=NOW + 10 * 86400)


def _counter_rebase(tmp_path):
    db = DB(str(tmp_path / "h.db"))
    store = ICIStore(db)
    big = 2_000_000_000
    for i, crc in enumerate((big, big + 90, big + 250, 5, 40)):  # then a reset
        store.insert_snapshot(
            [ICILinkSnapshot(chip_id=0, link_id=0, state=LinkState.UP,
                             crc_errors=crc)], ts=NOW - 300 + i * 60)
    db.close()
    return [str(tmp_path / "h.db")], dict(window_seconds=3600, now=NOW)


def _sub_minute_flaps(tmp_path):
    db = DB(str(tmp_path / "h.db"))
    store = ICIStore(db)
    for i, st in enumerate((LinkState.UP, LinkState.DOWN, LinkState.UP, LinkState.UP)):
        store.insert_snapshot([ICILinkSnapshot(chip_id=0, link_id=0, state=st)],
                              ts=NOW - 30 + i * 5)
    db.close()
    return [str(tmp_path / "h.db")], dict(window_seconds=3600, now=NOW)


def _raw_db(path, rows, tombstones=(), tombstone_table=True):
    """A host DB with the store's schema and ``rows`` (ts, link, state, crc)
    inserted in the order given, so rowids follow the list, not ts."""
    db = DB(str(path))
    store = ICIStore(db)
    db.executemany(f"INSERT INTO {torch_fs.TABLE} (ts, link, state, crc_errors) "
                   "VALUES (?, ?, ?, ?)", rows)
    for link, ts in tombstones:
        store.set_tombstone(link, ts=ts)
    if not tombstone_table:
        db.execute(f"DROP TABLE {torch_fs.TOMBSTONE_TABLE}")
    db.close()
    return str(path)


def _history(links, minutes=20, seed=0, crc_step=(0, 40)):
    """Rows of ``links``, one a minute up to NOW, in ts order: states mostly
    up, CRC counters rising by a random step."""
    rng = np.random.default_rng(seed)
    rows = []
    for k, link in enumerate(links):
        crc = np.cumsum(rng.integers(*crc_step, minutes)) + 1000 * k
        up = rng.random(minutes) > 0.15
        rows += [(NOW - (minutes - m) * 60, link, int(up[m]), int(crc[m]))
                 for m in range(minutes)]
    return sorted(rows, key=lambda r: r[0])


def _tied_timestamps(tmp_path):
    # equal ts within a link: their rowids order them, as the (link, ts)
    # index does
    rows = [(NOW - 300, "a", 1, 0), (NOW - 240, "a", 0, 10), (NOW - 240, "a", 1, 500),
            (NOW - 240, "b", 1, 7), (NOW - 240, "a", 0, 20), (NOW - 180, "b", 0, 7),
            (NOW - 180, "b", 1, 300), (NOW - 120, "a", 1, 30)]
    return [_raw_db(tmp_path / "h.db", rows)], dict(window_seconds=3600, now=NOW)


def _out_of_time_order(tmp_path):
    # a host whose rows went in shuffled: rowids do not follow ts
    rows = _history([f"gpu{g}/nvlink{n}" for g in range(2) for n in range(3)], seed=1)
    rows = [rows[i] for i in np.random.default_rng(2).permutation(len(rows))]
    return ([_raw_db(tmp_path / "h.db", rows[: len(rows) // 2] + [rows[-1]]),
             _raw_db(tmp_path / "g.db", rows)], dict(window_seconds=900, now=NOW))


def _non_ascii_names(tmp_path):
    # names that sort differently by bytes, case or code point than they read
    links = ["z", "Z", "é/0", "e/0", "f", "中/1", "Ω", "😀", "\uffef", "a b", "a/b",
             "gpu10/nvlink1", "gpu2/nvlink1", "ü"]
    return ([_raw_db(tmp_path / "ö.db", _history(links, seed=3)),
             _raw_db(tmp_path / "h.db", _history(links[::-1], seed=4))],
            dict(window_seconds=3600, now=NOW))


def _tombstoned_whole(tmp_path):
    # a link tombstoned after its last sample, and a host whose '*'
    # tombstone is newer than all its rows: neither is reported
    links = ["l0", "l1", "l2"]
    return ([_raw_db(tmp_path / "a.db", _history(links, seed=5),
                     tombstones=[("l1", NOW), ("l2", NOW - 600)]),
             _raw_db(tmp_path / "b.db", _history(links, seed=6), tombstones=[("*", NOW)]),
             _raw_db(tmp_path / "c.db", _history(links, seed=7),
                     tombstones=[("*", NOW - 300), ("l0", NOW - 600), ("l2", NOW - 120)])],
            dict(window_seconds=3600, now=NOW))


def _no_tombstone_table(tmp_path):
    return ([_raw_db(tmp_path / "old.db", _history(["l0", "l1"], seed=8), tombstone_table=False),
             _raw_db(tmp_path / "new.db", _history(["l0", "l1"], seed=9),
                     tombstones=[("l0", NOW - 300)])],
            dict(window_seconds=3600, now=NOW))


def _empty_db(tmp_path):
    return ([_raw_db(tmp_path / "a.db", _history(["l0"], seed=10)),
             _raw_db(tmp_path / "empty.db", []),
             _raw_db(tmp_path / "c.db", _history(["l1", "l0"], seed=11))],
            dict(window_seconds=3600, now=NOW))


def _stem_is_a_disambiguated_name(tmp_path):
    # rack3/host-2.db takes the name rack2/host.db was given: the reference
    # appends its rows to that host's links, after rack2's
    for rack in ("rack1", "rack2", "rack3", "rack4"):
        (tmp_path / rack).mkdir()
    return ([_raw_db(tmp_path / "rack1" / "host.db", _history(["l0", "l1"], seed=12)),
             _raw_db(tmp_path / "rack2" / "host.db", _history(["l1", "l3"], seed=13)),
             _raw_db(tmp_path / "rack4" / "x.db", _history(["l0"], seed=14)),
             _raw_db(tmp_path / "rack3" / "host-2.db", _history(["l2", "l3"], seed=15),
                     tombstones=[("l3", NOW - 300)])],
            dict(window_seconds=3600, now=NOW))


def _crc_past_int32(tmp_path):
    # counter values and deltas beyond int32 either way, clipped on rebase
    big = [0, 2**40, 3, 2**62, 2**31, 2**31 - 1, -(2**31), 2**63 - 1, 5]
    rows = [(NOW - 600 + 60 * i, "l0", 1, c) for i, c in enumerate(big)]
    rows += [(NOW - 600 + 60 * i, "l1", 1, 2**62 - c) for i, c in enumerate(big)]
    return [_raw_db(tmp_path / "h.db", rows)], dict(window_seconds=3600, now=NOW)


FLEETS = {
    "down_flappy_crc_hot": _fleet_ab,
    "global_and_per_link_tombstones": _tombstones,
    "same_stem_in_two_dirs": _same_stem,
    "empty_window": _empty_window,
    "counter_rebase_and_reset": _counter_rebase,
    "sub_minute_flaps": _sub_minute_flaps,
    "tied_timestamps": _tied_timestamps,
    "rows_out_of_time_order": _out_of_time_order,
    "non_ascii_link_names": _non_ascii_names,
    "links_and_a_host_wholly_tombstoned": _tombstoned_whole,
    "db_without_tombstone_table": _no_tombstone_table,
    "empty_db": _empty_db,
    "stem_is_a_disambiguated_name": _stem_is_a_disambiguated_name,
}


def _truncated(tmp_path):
    # one link of each host past the bound, ties among its rows; each cut
    # link's counter rebased on its first kept sample
    rows = [(NOW - 1200 + 60 * i, "l0", int(i % 5 != 2), 10**6 + 37 * i * i) for i in range(14)]
    rows += [(NOW - 1200 + 60 * i, "l1", 1, 5 * i) for i in range(4)]
    rows += [(NOW - 300, "l0", 0, 7), (NOW - 300, "l0", 1, 3 * 10**9)]
    rows.sort(key=lambda r: r[0])
    return ([_raw_db(tmp_path / "a.db", rows),
             _raw_db(tmp_path / "b.db", _history(["m0", "m1"], seed=16),
                     tombstones=[("m1", NOW - 600)])],
            dict(window_seconds=3600, now=NOW, max_samples=6))


def _truncated_after_a_merge(tmp_path):
    for rack in ("rack1", "rack2"):
        (tmp_path / rack).mkdir()
    return ([_raw_db(tmp_path / "rack1" / "host.db", _history(["l0"], minutes=5, seed=17)),
             _raw_db(tmp_path / "rack2" / "host.db", _history(["l0", "l1"], minutes=4, seed=18)),
             _raw_db(tmp_path / "host-2.db", _history(["l0"], minutes=6, seed=19))],
            dict(window_seconds=3600, now=NOW, max_samples=7))


def _clipped_cut_over_two_dbs(tmp_path):
    # host-2.db continues rack2/host.db's host: l0's counter leaves int32
    # against its first sample in the first DB and the second DB cuts it; each
    # DB's tombstones hold for its own rows alone
    for rack in ("rack1", "rack2"):
        (tmp_path / rack).mkdir()
    first = [(NOW - 1200 + 60 * i, link, 1, c) for i in range(6) for link, c in (
        ("l0", 0 if i == 0 else 2**40 + 5 * i), ("l1", 3 * i))]
    second = [(NOW - 600 + 60 * i, link, int(i % 3 != 1), c) for i in range(5) for link, c in (
        ("l0", 2**40 + 100 + 9 * i), ("l1", 40 + i))]
    return ([_raw_db(tmp_path / "rack1" / "host.db", _history(["m0"], minutes=3, seed=20)),
             _raw_db(tmp_path / "rack2" / "host.db", first, tombstones=[("l1", NOW - 1100)]),
             _raw_db(tmp_path / "host-2.db", second, tombstones=[("*", NOW - 500)])],
            dict(window_seconds=3600, now=NOW, max_samples=5))


# cases of the loader alone: they pass it max_samples, or hold counters whose
# steps overflow the reference's int32 scan (ROADMAP C18)
LOADER_ONLY = {
    "crc_past_int32": _crc_past_int32,
    "truncated_and_rebased": _truncated,
    "truncated_after_a_merge": _truncated_after_a_merge,
    "clipped_cut_over_two_dbs": _clipped_cut_over_two_dbs,
}


def _assert_same_history(ref, got):
    names, states, counters, valid, truncated = got
    assert names == ref[0]
    assert truncated == ref[4]
    for a, b in zip((states, counters, valid), ref[1:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fleet", sorted(FLEETS) + sorted(LOADER_ONLY))
def test_load_fleet_history_matches_reference(tmp_path, fleet):
    paths, kw = {**FLEETS, **LOADER_ONLY}[fleet](tmp_path)
    _assert_same_history(jax_fs.load_fleet_history(paths, **kw),
                         torch_fs.load_fleet_history(paths, **kw))


def test_load_fleet_history_truncation_matches_reference(tmp_path):
    db = DB(str(tmp_path / "h.db"))
    store = ICIStore(db)
    for i in range(50):
        store.insert_snapshot(
            [ICILinkSnapshot(chip_id=0, link_id=0,
                             state=LinkState.DOWN if i % 7 == 3 else LinkState.UP)],
            ts=NOW - 3000 + i * 10)
    db.close()
    kw = dict(window_seconds=3600, now=NOW, max_samples=20)
    got = torch_fs.load_fleet_history([str(tmp_path / "h.db")], **kw)
    _assert_same_history(
        jax_fs.load_fleet_history([str(tmp_path / "h.db")], **kw), got)
    assert got[4] == ["h/chip0/ici0"] and got[1].shape == (1, 20)


def _compare_fleet_scan(paths, **kw):
    ref = jax_fs.fleet_scan(paths, **kw)
    got = torch_fs.fleet_scan(paths, device="cpu", **kw)
    for key in ("window_seconds", "links", "summary", "truncated_links"):
        assert got[key] == ref[key], key
    assert got["devices"] == (1 if got["links"] else 0)
    return got


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_fleet_scan_matches_reference(tmp_path, fleet):
    paths, kw = FLEETS[fleet](tmp_path)
    got = _compare_fleet_scan(paths, **kw)
    if fleet == "down_flappy_crc_hot":
        assert got["links"]["hostA/chip0/ici0"] == "unhealthy"
        assert got["links"]["hostB/chip1/ici1"] == "unhealthy"
        assert got["links"]["hostC/chip0/ici1"] == "degraded"
        assert got["summary"] == {"healthy": 9, "degraded": 1, "unhealthy": 2}
    elif fleet == "global_and_per_link_tombstones":
        assert got["links"]["g/chip0/ici0"] == got["links"]["g/chip1/ici1"] == "healthy"
        assert got["links"]["p/chip0/ici0"] == "healthy"
        assert got["links"]["p/chip1/ici1"] == "unhealthy"
    elif fleet == "empty_window":
        assert got["links"] == {} and got["devices"] == 0


@pytest.mark.parametrize("thresholds", [dict(flap_threshold=1, crc_threshold=2000),
                                        dict(flap_threshold=10, crc_threshold=10)])
def test_fleet_scan_thresholds_match_reference(tmp_path, thresholds):
    paths, kw = _fleet_ab(tmp_path)
    _compare_fleet_scan(paths, **kw, **thresholds)


def test_fleet_scan_truncation_matches_reference(tmp_path):
    # one link denser than the 14-days-of-minutes array bound
    n = torch_fs.MAX_STEPS + 40
    db = DB(str(tmp_path / "h.db"))
    ICIStore(db)
    ts = NOW - n + np.arange(n)
    state = np.ones(n, dtype=int)
    state[5:9] = 0  # a flap in the oldest samples, which truncation drops
    db.executemany(
        f"INSERT INTO {torch_fs.TABLE} (ts, link, state) VALUES (?, ?, ?)",
        [(float(t), "chip0/ici0", int(s)) for t, s in zip(ts, state)],
    )
    db.close()
    got = _compare_fleet_scan([str(tmp_path / "h.db")], window_seconds=3600 * 24,
                              now=NOW)
    assert got["truncated_links"] == ["h/chip0/ici0"]
    assert got["links"]["h/chip0/ici0"] == "healthy"


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = json.loads(capsys.readouterr().out)
    out.pop("devices")
    return rc, out


def test_cli_json_matches_reference_cli(tmp_path, capsys):
    # both CLIs scan up to the wall clock, so the history ends just now
    now = time.time()
    paths = []
    for host, kw in (("hostA", dict(down=("chip0/ici0",))),
                     ("hostB", dict(crc_hot=("chip1/ici0",)))):
        _mk_host_db(tmp_path / f"{host}.db", now=now, **kw)[0].close()
        paths.append(str(tmp_path / f"{host}.db"))
    argv = ["fleet-scan", "--json", "--window", "3600", *paths]
    rc_ref, ref = _run_cli(jax_cli.main, argv, capsys)
    rc, got = _run_cli(torch_cli.main, [*argv, "--device", "cpu"], capsys)
    assert (rc, got) == (rc_ref, ref)
    assert rc == 1 and got["summary"]["unhealthy"] == 1


def test_cli_text_output(tmp_path, capsys):
    _mk_host_db(tmp_path / "h.db", now=time.time(), flappy=("chip1/ici0",))[0].close()
    rc = torch_cli.main(["fleet-scan", "--device", "cpu", str(tmp_path / "h.db")])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert out[0] == ("4 links across 1 host DB(s) on 1 device(s): "
                      "3 healthy, 0 degraded, 1 unhealthy")
    assert out[1:] == ["  unhealthy  h/chip1/ici0"]


def test_module_entry_point_runs_on_request_cpu(tmp_path):
    _mk_host_db(tmp_path / "h.db", now=time.time())[0].close()
    proc = subprocess.run(
        [sys.executable, "-m", "gpud_tpu_torch", "fleet-scan", "--json",
         "--device", "cpu", str(tmp_path / "h.db")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout)
    assert res["summary"] == {"healthy": 4, "degraded": 0, "unhealthy": 0}
    assert res["devices"] == 1
