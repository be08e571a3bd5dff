"""Plain reference of a fleet link sweep: host DB files in, classes out.

It reads each DB with its own query, takes every row, or every row from a
margin before the window's start on (the window's edge is applied here, not
in SQL), honours the set-healthy tombstones (a row older than
``max(tombstone['*'], tombstone[link])`` is dropped, and a link left with
no rows is not reported), walks each link's rows in time order, and applies
the link store's rules:

- ``drops`` / ``flaps``: consecutive samples up then down / down then up
  (up is a state of 1 or more);
- ``currently_down``: the last sample is not up;
- ``crc_delta``: the sum of the positive steps of the CRC counter, so a
  counter that resets adds nothing for the reset;
- class: unhealthy if currently down or drops or flaps reach the flap
  threshold, degraded if any drop, flap or a CRC delta at the CRC
  threshold, else healthy;
- a link with more than ``max_samples`` samples keeps its latest and is
  listed in ``truncated_links``.

Links are named ``<db stem>/<link>``; a stem seen before gets ``-2``,
``-3``, ... in the order the paths are given. The DBs are read and judged
side by side, one ``host_links`` call a DB in child interpreters
(``children.call_all``); names and the order of the answer are decided here.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Dict, List, Optional
from urllib.parse import quote

import numpy as np

from .children import call_all

CLASS_NAMES = ("healthy", "degraded", "unhealthy")
MAX_SAMPLES = 20160


def _read_host(path: str, since: Optional[float] = None):
    """The DB's rows at or after ``since`` (every row if None), and its
    tombstones."""
    conn = sqlite3.connect(f"file:{quote(os.path.abspath(path))}?mode=ro", uri=True)
    try:
        query = "SELECT link, ts, state, crc_errors FROM tpud_ici_snapshots_v0_1"
        rows = (conn.execute(query).fetchall() if since is None
                else conn.execute(query + " WHERE ts >= ?", (since,)).fetchall())
        try:
            tombs = dict(conn.execute(
                "SELECT link, ts FROM tpud_ici_tombstones_v0_1").fetchall())
        except sqlite3.OperationalError:  # a store without the table
            tombs = {}
    finally:
        conn.close()
    return rows, tombs


def host_links(path: str, start: float, flap_threshold: int, crc_threshold: int,
               max_samples: int, tombstones: bool = True, since: Optional[float] = None):
    """(link names, classes, truncated names) of one DB, links sorted, from
    its rows at or after ``since`` (all if None; ``start`` cuts them again).
    ``tombstones=False`` ignores set-healthy (the control, which breaks that
    guarantee on purpose)."""
    rows, tombs = _read_host(path, since)
    if not tombstones:
        tombs = {}
    if not rows:
        return [], np.zeros(0, dtype=np.int64), []
    link_s, ts_s, st_s, crc_s = zip(*rows)
    names = sorted(set(link_s))
    index = {n: i for i, n in enumerate(names)}
    link = np.fromiter((index[x] for x in link_s), dtype=np.int64, count=len(rows))
    ts = np.asarray(ts_s, dtype=np.float64)
    st = np.asarray(st_s, dtype=np.int64)
    crc = np.asarray(crc_s, dtype=np.int64)

    floor = np.array([max(tombs.get("*", 0.0), tombs.get(n, 0.0)) for n in names])
    keep = (ts >= start) & (ts >= floor[link])
    link, ts, st, crc = link[keep], ts[keep], st[keep], crc[keep]
    order = np.lexsort((ts, link))
    link, st, crc = link[order], st[order], crc[order]

    counts = np.bincount(link, minlength=len(names))
    truncated = [names[i] for i in np.flatnonzero(counts > max_samples)]
    if truncated:  # keep each link's latest max_samples
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(link)) - first[link]
        keep = rank >= counts[link] - max_samples
        link, st, crc = link[keep], st[keep], crc[keep]
        counts = np.bincount(link, minlength=len(names))

    up = st >= 1
    same = link[1:] == link[:-1]
    drops = np.bincount(link[1:], weights=same & up[:-1] & ~up[1:], minlength=len(names))
    flaps = np.bincount(link[1:], weights=same & ~up[:-1] & up[1:], minlength=len(names))
    step = np.where(same, np.maximum(crc[1:] - crc[:-1], 0), 0)
    # float64 sums are exact below 2**53
    delta = np.bincount(link[1:], weights=step, minlength=len(names)).astype(np.int64)
    last = np.cumsum(counts) - 1
    present = counts > 0
    down = np.zeros(len(names), dtype=bool)
    down[present] = ~up[last[present]]

    heavy = (drops >= flap_threshold) | (flaps >= flap_threshold)
    degraded = (drops > 0) | (flaps > 0) | (delta >= crc_threshold)
    cls = np.where(down | heavy, 2, np.where(degraded, 1, 0))
    kept = np.flatnonzero(present)
    return [names[i] for i in kept], cls[kept], truncated


def sweep(db_paths: List[str], window_seconds: float, now: float,
          flap_threshold: int = 3, crc_threshold: int = 100,
          max_samples: int = MAX_SAMPLES, tombstones: bool = True,
          margin_seconds: Optional[float] = None) -> dict:
    """The sweep's answer: ``links`` (name → class), ``summary`` (class →
    count) and ``truncated_links`` (sorted). With ``margin_seconds``, rows
    older than that margin before the window's start are not read; no row
    before the start counts, so every margin of 0 or more gives one answer."""
    start = now - window_seconds
    since = None if margin_seconds is None else start - margin_seconds
    hosts: List[str] = []
    seen: Dict[str, int] = {}
    for path in db_paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        seen[stem] = seen.get(stem, 0) + 1
        hosts.append(stem if seen[stem] == 1 else f"{stem}-{seen[stem]}")
    per_db = call_all(host_links, [(path, start, flap_threshold, crc_threshold, max_samples,
                                    tombstones, since) for path in db_paths])
    links: Dict[str, str] = {}
    truncated: List[str] = []
    for host, (names, cls, trunc) in zip(hosts, per_db):
        for n, c in zip(names, cls.tolist()):
            links[f"{host}/{n}"] = CLASS_NAMES[c]
        truncated += [f"{host}/{n}" for n in trunc]
    summary = {c: 0 for c in CLASS_NAMES}
    for c in links.values():
        summary[c] += 1
    return {"links": links, "summary": summary, "truncated_links": sorted(truncated)}
