"""Set-up and judgement side by side in child interpreters: the writer
leaves every DB byte for byte as the serial writer does, the reference
gives the serial reference's answer, and a child that fails fails the
call, leaving no fleet behind. At 4 hosts on the CPU."""

import dataclasses
import operator
import os
import shutil
import subprocess
import time

import pytest

from conftest import small_cell

from fleetbench import harness, retained
from fleetbench.reference import children
from fleetbench.reference import fleet as reference
from fleetbench.store import write_host_db

SEED = 2**31 + 41
# the retained store cut to one day, its purge scaled to it
DAY = {"store_retention_seconds": 86400, "store_purge_interval_seconds": 17280,
       "store_last_purge_age_seconds": 8640}


def cell_of(workload):
    cell = small_cell(workload, hosts=4)
    if "store_retention_seconds" in cell.config:
        cell.config = dict(cell.config, **DAY)
    return cell


def fleet_of(cell, seed=SEED):
    return cell.generator.generate(cell.config, cell.traffic, seed, harness.NOW)


def serial_write(fleet, workdir, config):
    """Every DB written one after another in this process: the generated
    rows alone, or beneath them the retained store's template."""
    paths = [os.path.join(workdir, f"{h.name}.db") for h in fleet.hosts]
    cache_kib = None
    if "store_retention_seconds" in config:
        plan = retained.schedule(config, max(float(h.ts[0]) for h in fleet.hosts), fleet.now)
        template = os.path.join(workdir, "template")
        retained.write_template(template, fleet.hosts[0].links, plan)
        for path in paths:
            shutil.copyfile(template, path)
        os.unlink(template)
        cache_kib = retained.APPEND_CACHE_KIB
    for h, path in zip(fleet.hosts, paths):
        write_host_db(path, h.links, h.ts, h.states, h.crc, h.tombstones, cache_kib)
    return paths


@pytest.mark.parametrize("workload", ["su-hour", "superpod-hour", "su-shift", "su-day",
                                      "su-hour-retained"])
def test_every_db_is_the_serial_writer_s(tmp_path, workload):
    cell = cell_of(workload)
    fleet = fleet_of(cell)
    for side in ("serial", "children"):
        (tmp_path / side).mkdir()
    want = serial_write(fleet, str(tmp_path / "serial"), cell.config)
    got, store = harness.write_fleet(fleet, str(tmp_path / "children"), cell.config)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "children")) == sorted(os.listdir(tmp_path / "serial"))
    assert store["db_bytes"] == sum(os.path.getsize(p) for p in want)
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_a_child_that_raises_fails_write_fleet(tmp_path):
    cell = cell_of("su-hour")
    fleet = fleet_of(cell)
    fleet.hosts[2].name = "missing/" + fleet.hosts[2].name  # a folder nobody made
    with pytest.raises(children.ChildFailed, match="No such file or directory"):
        harness.write_fleet(fleet, str(tmp_path), cell.config)
    assert os.listdir(tmp_path) == []  # the other hosts' DBs are gone too


def _fleet_with_every_case(tmp_path):
    """A generated fleet (host and link tombstones, a reboot gap, the
    window's edge), two more DBs whose stems it has, and a DB with no rows."""
    cell = cell_of("su-hour")
    fleet = fleet_of(cell)
    paths, _store = harness.write_fleet(fleet, str(tmp_path), cell.config)
    assert any("*" in h.tombstones for h in fleet.hosts)
    assert any(len(h.tombstones) > ("*" in h.tombstones) for h in fleet.hosts)
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        paths.append(str(tmp_path / sub / os.path.basename(paths[1])))
        shutil.copyfile(paths[3 if sub == "a" else 0], paths[-1])
    empty = str(tmp_path / "empty.db")
    h = fleet.hosts[0]
    write_host_db(empty, h.links, h.ts[:0], h.states[:, :0], h.crc[:, :0], {})
    paths.insert(2, empty)
    return paths, float(cell.traffic["window_seconds"]), cell.config


def cores(monkeypatch, n):
    monkeypatch.setattr(children.os, "sched_getaffinity", lambda _pid: set(range(n)))


@pytest.mark.parametrize("n_cores", [1, 3, 8, 16])
@pytest.mark.parametrize("max_samples", [reference.MAX_SAMPLES, 40])
@pytest.mark.parametrize("tombstones", [True, False])
def test_the_fanned_out_reference_is_the_serial_one(tmp_path, monkeypatch, n_cores,
                                                    max_samples, tombstones):
    paths, window, config = _fleet_with_every_case(tmp_path)
    kw = dict(max_samples=max_samples, tombstones=tombstones,
              margin_seconds=config["history_before_window_seconds"])
    with monkeypatch.context() as m:  # every DB read here, one after another
        m.setattr(reference, "call_all", lambda fn, calls: [fn(*c) for c in calls])
        want = reference.sweep(paths, window, harness.NOW, **kw)
    cores(monkeypatch, n_cores)
    got = reference.sweep(paths, window, harness.NOW, **kw)
    assert got == want and list(got["links"]) == list(want["links"])
    hosts = {k.split("/")[0] for k in got["links"]}
    assert {"dgx001-2", "dgx001-3"} <= hosts and "empty" not in hosts
    assert len(got["links"]) == 6 * 144
    assert bool(got["truncated_links"]) == (max_samples == 40)


@pytest.mark.parametrize("n_cores, workers, children_run", [(3, None, 3), (3, 2, 2), (3, 40, 3),
                                                          (16, None, 11)])
def test_answers_come_back_in_the_calls_order(monkeypatch, n_cores, workers, children_run):
    cores(monkeypatch, n_cores)
    assert children.call_all(operator.add, [(i, 100) for i in range(11)], workers) == \
        [i + 100 for i in range(11)]
    assert len(set(children.call_all(os.getpid, [()] * 11, workers))) == children_run
    assert children.call_all(operator.add, []) == []


@pytest.mark.parametrize("rows, writers", [(1, 1), (harness.ROWS_PER_WRITER, 1),
                                           (harness.ROWS_PER_WRITER + 1, 2), (10**9, 4)])
def test_one_writer_a_share_of_rows_at_most_one_a_core(tmp_path, monkeypatch, rows, writers):
    cores(monkeypatch, 4)
    cell = cell_of("su-hour")
    fleet = fleet_of(cell)
    fleet.rows_stored = rows
    seen = []

    def spy(fn, calls, workers=None):
        seen.append(min(len(calls), len(children.os.sched_getaffinity(0)), workers))
        return call_all(fn, calls, workers)

    call_all = children.call_all
    monkeypatch.setattr(children, "call_all", spy)
    harness.write_fleet(fleet, str(tmp_path), cell.config)
    assert seen == [writers]


def test_children_are_fresh_interpreters(monkeypatch):
    import torch  # noqa: F401  (loaded here, and not in a child)

    cores(monkeypatch, 1)
    code = "sorted({m.split('.')[0] for m in __import__('sys').modules})"
    mods, pid = children.call_all(eval, [(code,), ("__import__('os').getpid()",)])
    assert "torch" not in mods and "numpy" not in mods and pid != os.getpid()


def test_leaving_early_ends_every_child(monkeypatch):
    started = []

    class Popen(subprocess.Popen):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            started.append(self)

        def communicate(self, *args, **kwargs):
            raise KeyboardInterrupt  # as a signal would, while the children run

    cores(monkeypatch, 4)
    monkeypatch.setattr(children.subprocess, "Popen", Popen)
    with pytest.raises(KeyboardInterrupt):
        children.call_all(time.sleep, [(60,)] * 4)
    assert len(started) == 4 and all(p.returncode is not None for p in started)


def test_a_cell_is_set_up_in_a_child(tmp_path, monkeypatch):
    cell = cell_of("su-shift")
    want = fleet_of(cell)
    monkeypatch.setattr(cell.generator, "generate", None)  # not called in this process
    fleet, paths, store, marks = harness.set_up(cell, SEED, str(tmp_path), 0.0)
    assert fleet == dataclasses.replace(want, hosts=[])
    assert paths == [str(tmp_path / f"{h.name}.db") for h in want.hosts]
    assert store["rows_stored"] == want.rows_stored and store["db_bytes"] > 0
    assert 0 < marks["start"] < marks["generated"]
