"""Host DBs at the link store's retained depth.

A host's daemon inserts one snapshot of every link each sweep interval and,
every ``store_purge_interval_seconds`` (the store's retention / 5), deletes
the rows older than ``store_retention_seconds``; its first purge runs at its
first insert. So its DB holds from the retention to the retention plus one
purge interval of history, partly on pages that the last purge freed.

The history older than the generated rows is the same on every host and no
sweep reads it, so it is written once a run, as a template:

- fault-free: every link up, CRC 0, one snapshot per sweep interval, the
  links of a snapshot in the host's order, each snapshot inserted into the
  indexed table after the one before (sweep-major, as the daemon inserts);
- from the daemon's start, the earliest from which no purge before the last
  deleted a row, up to one interval before the generator's first slot;
- purged once, inside: at the sample ``store_last_purge_age_seconds`` before
  the generator's clock (``DELETE ... WHERE ts<?`` with the retention's
  cutoff, after that sample's insert), then continued into the pages freed.

It is then copied to each host's path, and the host's generated rows and
tombstones are appended by ``store.write_host_db``, as for a store without
the depth. All of that runs in a process of its own.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sqlite3
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from fleetbench.store import DDL, TABLE, write_host_db

# an append's page cache: the pages it reads and dirties stay until its commit
APPEND_CACHE_KIB = 65536
# the hosts' generated rows, handed to the process that writes the DBs
HOSTS_JSON, HOSTS_NPZ = "hosts.json", "hosts.npz"

# one statement a stretch of snapshots; CROSS JOIN keeps the snapshots the
# outer loop, so the rows go in snapshot by snapshot, each in the links' order
INSERT_STRETCH = (
    "WITH RECURSIVE s(k) AS (SELECT 0 UNION ALL SELECT k + 1 FROM s WHERE k < ?), "
    "links(name) AS (VALUES {values}) "
    f"INSERT INTO {TABLE} (ts, link, state, crc_errors) "
    "SELECT ? + k * ?, links.name, 1, 0 FROM s CROSS JOIN links"
)


def schedule(config: dict, first_slot: float, now: float) -> Dict[str, float]:
    """The template's times: its ``first`` and ``last`` sample, the last
    ``purge``'s sample and ``cutoff``, the ``oldest`` sample it keeps, and the
    snapshots ``written`` and ``kept``."""
    step = float(config["snapshot_interval_seconds"])
    retention = float(config["store_retention_seconds"])
    interval = float(config["store_purge_interval_seconds"])
    before = config["store_last_purge_age_seconds"] - (now - first_slot)
    if before < step:
        raise ValueError("the last purge falls on the generated rows: "
                         "store_last_purge_age_seconds is too small")
    m_purge = math.ceil(before / step)  # the purge's sample, in slots before the first slot
    # the daemon's start: its purges one interval apart, none before the last deleting
    m_start = m_purge + math.ceil((retention + interval) / step)
    first, last = first_slot - step * m_start, first_slot - step
    purge = first_slot - step * m_purge
    cutoff = purge - retention
    oldest = first + step * math.ceil((cutoff - first) / step)
    return {"step": step, "first": first, "last": last, "purge": purge, "cutoff": cutoff,
            "oldest": oldest, "written": m_start, "kept": round((last - oldest) / step) + 1}


def _insert(conn, links: List[str], t0: float, n: int, step: float) -> None:
    if n > 0:
        values = ",".join(["(?)"] * len(links))
        conn.execute(INSERT_STRETCH.format(values=values), [n - 1, *links, t0, step])


def write_template(path: str, links: List[str], plan: Dict[str, float]) -> None:
    """The template at ``path``, with a page cache past its size (a row with
    its share of the indexes takes under 100 B), so that each page is
    written to the file once; the cache changes no byte of the file."""
    step = plan["step"]
    conn = sqlite3.connect(path)
    try:
        conn.execute("PRAGMA journal_mode=OFF")
        conn.execute("PRAGMA synchronous=OFF")
        conn.execute(f"PRAGMA cache_size=-{plan['written'] * len(links) * 100 // 1024}")
        for ddl in DDL:
            conn.execute(ddl)
        before = round((plan["purge"] - plan["first"]) / step) + 1  # the purge's sample too
        _insert(conn, links, plan["first"], before, step)
        conn.execute(f"DELETE FROM {TABLE} WHERE ts<?", (plan["cutoff"],))
        _insert(conn, links, plan["purge"] + step, plan["written"] - before, step)
        conn.commit()
    finally:
        conn.close()


def write_dbs(workdir: str, plan: Dict[str, float], hosts: List[dict]) -> Dict[str, float]:
    """The template, its copies to ``<workdir>/<name>.db`` (on threads) and
    each host's rows appended (one host after another: appends side by side
    were several times slower on the card's host). ``hosts`` holds each
    host's ``name``, ``links``, ``ts``, ``states``, ``crc`` and
    ``tombstones``. Returns the seconds each of the three took."""
    t = [time.perf_counter()]
    links = hosts[0]["links"]
    template = os.path.join(workdir, "template.db")
    write_template(template, links, plan)
    t.append(time.perf_counter())
    paths = [os.path.join(workdir, f"{h['name']}.db") for h in hosts]
    with ThreadPoolExecutor(min(len(paths), os.cpu_count() or 1)) as pool:
        list(pool.map(lambda path: shutil.copyfile(template, path), paths))
    os.unlink(template)
    t.append(time.perf_counter())
    for h, path in zip(hosts, paths):
        write_host_db(path, h["links"], h["ts"], h["states"], h["crc"], h["tombstones"],
                      cache_kib=APPEND_CACHE_KIB)
    t.append(time.perf_counter())
    return dict(zip(("template", "copied", "written"), np.diff(t).tolist()))


def _write_dbs_from(workdir: str, plan_json: str) -> None:
    """``write_dbs`` on the hosts ``write_fleet`` left in ``workdir``; the
    seconds on standard output."""
    with open(os.path.join(workdir, HOSTS_JSON)) as f:
        hosts = json.load(f)
    with np.load(os.path.join(workdir, HOSTS_NPZ)) as arrays:
        for i, h in enumerate(hosts):
            h.update(ts=arrays[f"ts{i}"], states=arrays[f"states{i}"], crc=arrays[f"crc{i}"])
    print(json.dumps(write_dbs(workdir, json.loads(plan_json), hosts)))


def write_fleet(fleet, workdir: str, config: dict,
                marks: Optional[Dict[str, float]] = None, t0: float = 0.0):
    """Write every host's DB at the retained depth, by ``write_dbs`` in a
    process of its own: the page caches' memory goes with it, and the
    sweeps meet this process's heap as a store without the depth leaves it.
    Returns the paths and what the store holds (``rows_stored``, the
    template's rows and times); ``marks`` gets the seconds since ``t0``
    after the template, the copies and the appends."""
    marks = {} if marks is None else marks
    links = fleet.hosts[0].links
    if any(h.links != links for h in fleet.hosts):
        raise ValueError("the template needs the same links on every host")
    plan = schedule(config, max(float(h.ts[0]) for h in fleet.hosts), fleet.now)
    with open(os.path.join(workdir, HOSTS_JSON), "w") as f:
        json.dump([{"name": h.name, "links": h.links, "tombstones": h.tombstones}
                   for h in fleet.hosts], f)
    np.savez(os.path.join(workdir, HOSTS_NPZ), **{
        f"{k}{i}": getattr(h, k) for i, h in enumerate(fleet.hosts)
        for k in ("ts", "states", "crc")})
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from fleetbench.retained import _write_dbs_from; _write_dbs_from(*sys.argv[2:])")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, str(Path(__file__).resolve().parents[1]),
                          workdir, json.dumps(plan)],
                         check=True, stdout=subprocess.PIPE, text=True).stdout
    for name in (HOSTS_JSON, HOSTS_NPZ):
        os.unlink(os.path.join(workdir, name))
    for name, seconds in json.loads(out.splitlines()[-1]).items():
        t += seconds
        marks[name] = t - t0
    template_rows = plan["kept"] * len(links)
    store = {"template_rows": template_rows,
             "template_rows_written": plan["written"] * len(links),
             "rows_stored": fleet.rows_stored + template_rows * len(fleet.hosts),
             "rows_per_db_min": template_rows + min(h.states.size for h in fleet.hosts),
             "store_days": (fleet.now - plan["oldest"]) / 86400,
             "template_times": plan}
    return [os.path.join(workdir, f"{h.name}.db") for h in fleet.hosts], store
