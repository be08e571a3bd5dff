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


FLEETS = {
    "down_flappy_crc_hot": _fleet_ab,
    "global_and_per_link_tombstones": _tombstones,
    "same_stem_in_two_dirs": _same_stem,
    "empty_window": _empty_window,
    "counter_rebase_and_reset": _counter_rebase,
    "sub_minute_flaps": _sub_minute_flaps,
}


def _assert_same_history(ref, got):
    names, states, counters, valid, truncated = got
    assert names == ref[0]
    assert truncated == ref[4]
    for a, b in zip((states, counters, valid), ref[1:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_load_fleet_history_matches_reference(tmp_path, fleet):
    paths, kw = FLEETS[fleet](tmp_path)
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
