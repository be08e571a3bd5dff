"""Fleet-wide link-history scan on the card.

Counterpart of ``gpud_tpu/fleet_scan.py``. Per-host daemons keep 14 days of
per-link snapshots in their state DBs (``tpud_ici_snapshots_v0_1``, written
by ``ICIStore``). An operator sweeps every host's history at once: the
fleet's history packs into [L, T] arrays, one CUDA kernel launch scans every
link (``ops/packed_scan.py``), and the health classes follow on the same
device; on a host with more than one card the links are split into one
block per card, as the reference shards them over its mesh.

Entry point: ``python -m gpud_tpu_torch fleet-scan host1.db host2.db ...``.
Each DB is opened read-only; link names are prefixed with the DB's stem
(disambiguated when two DBs share a filename) and set-healthy tombstones
are honoured exactly like the per-host scan.

Histories are packed: each link's snapshots sit left-aligned in ts order
with suffix padding (a prefix validity mask), so every consecutive snapshot
pair is compared exactly like ``ICIStore.scan`` walks them. Per-link sample
counts are bounded by ``MAX_STEPS`` (14 days of minutes).

Each sweep records its spans in the trace ring (``tracing.DEFAULT_TRACER``,
component ``"fleet_scan"``), one per layer and none per DB or row:

    fleet_scan.sweep                 dbs, links, devices, cpu_s
      fleet_scan.load                dbs, rows_fetched, rows_tombstoned,
                                     rows_kept, open_s, fetch_s,
                                     slowest_db, slowest_db_s
        fleet_scan.pack              links, t_max, truncated
      fleet_scan.split               devices, h2d_bytes
        fleet_scan.h2d               bytes        } once per device
        fleet_scan.scan              L, T         }
        fleet_scan.classify                       }
        fleet_scan.gather
      fleet_scan.assemble

While a torch profiler records, each span is also a profiler annotation of
the same name, so the spans sit on the device trace's clock beside the
copies and kernels they launched.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote

import numpy as np
import torch

from gpud_tpu_torch import tracing
from gpud_tpu_torch.device import DeviceLike, resolve_device
from gpud_tpu_torch.ops.packed_scan import packed_from_numpy, scan_links_packed
from gpud_tpu_torch.ops.window_scan import classify_links

logger = logging.getLogger(__name__)

TABLE = "tpud_ici_snapshots_v0_1"  # the schema of components/gpu/nvlink_store.py
TOMBSTONE_TABLE = "tpud_ici_tombstones_v0_1"

DEFAULT_WINDOW_SECONDS = 3600.0
# dense-array bound: 14 days of minutes; a denser link keeps its latest
# samples and is reported as truncated
MAX_STEPS = 20160

CLASS_NAMES = ("healthy", "degraded", "unhealthy")

COMPONENT = "fleet_scan"  # the spans' component in the trace ring
# rows per cursor fetch: SQLite's stepping is timed per batch, apart from
# the Python loop over the rows, at no cost per row. A batch's row tuples
# are alive at once and leave their memory to the interpreter's pools: 4096
# rows added 1.2 MB to a 32-host sweep's resident peak on an H100 host, 256
# rows 0.2 MB
FETCH_ROWS = 256


@contextmanager
def _span(name: str, attrs: Optional[Dict] = None):
    """A span of this module in the trace ring and, only while a torch
    profiler records, a profiler annotation of the same name: entering
    ``record_function`` costs tens of microseconds even with no profiler."""
    with tracing.span(name, COMPONENT, attrs) as sp:
        if torch._C._autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield sp
        else:
            yield sp


def load_fleet_history(
    db_paths: List[str],
    window_seconds: float = DEFAULT_WINDOW_SECONDS,
    now: Optional[float] = None,
    max_samples: int = MAX_STEPS,
):
    """Read every host DB's snapshots in the window into packed arrays.

    Returns (names, states, counters, valid, truncated) where names[i]
    labels row i as ``<host>/<link>``; arrays are numpy [L, T] (int8, int32,
    bool) with each link's samples left-aligned in ts order (``valid`` is a
    prefix mask). A link exceeding ``max_samples`` keeps its LATEST samples
    and is reported in ``truncated``, never silently.

    Recorded as the ``fleet_scan.load`` span: rows fetched from SQLite,
    dropped by set-healthy tombstones and kept; seconds in the opens (connect
    and tombstone read) and in SQLite's fetch calls, summed over the DBs; and
    the DB that took longest from open to close.
    """
    t_now = now if now is not None else time.time()
    start = t_now - window_seconds

    seqs: Dict[str, List[Tuple[int, int]]] = {}  # name → [(state, crc), ...]
    names: List[str] = []
    used_hosts: Dict[str, int] = {}
    fetched = tombstoned = 0
    open_s = fetch_s = slowest_s = 0.0
    slowest = ""
    with _span("fleet_scan.load") as sp:
        for path in db_paths:
            host = os.path.splitext(os.path.basename(path))[0]
            # two DBs named host1.db in different dirs must not merge
            n_seen = used_hosts.get(host, 0)
            used_hosts[host] = n_seen + 1
            if n_seen:
                host = f"{host}-{n_seen + 1}"
            # read-only URI; the path is escaped because '?', '#' or '%' would
            # otherwise be parsed as URI syntax
            uri = f"file:{quote(os.path.abspath(path))}?mode=ro"
            t_open = time.perf_counter()
            conn = sqlite3.connect(uri, uri=True)
            try:
                tombstones = {}
                try:
                    tombstones = dict(
                        conn.execute(f"SELECT link, ts FROM {TOMBSTONE_TABLE}")
                    )
                except sqlite3.OperationalError:
                    pass  # older DB without the table
                global_ts = tombstones.get("*", 0.0)
                t_fetch = time.perf_counter()
                open_s += t_fetch - t_open
                cur = conn.execute(
                    f"SELECT link, ts, state, crc_errors FROM {TABLE} "
                    "WHERE ts>=? ORDER BY link, ts ASC",
                    (start,),
                )
                while True:
                    batch = cur.fetchmany(FETCH_ROWS)
                    fetch_s += time.perf_counter() - t_fetch
                    if not batch:
                        break
                    fetched += len(batch)
                    for link, ts, state, crc in batch:
                        # honour set-healthy exactly like ICIStore.scan
                        if ts < max(global_ts, tombstones.get(link, 0.0)):
                            tombstoned += 1
                            continue
                        name = f"{host}/{link}"
                        if name not in seqs:
                            seqs[name] = []
                            names.append(name)
                        seqs[name].append((int(state), int(crc)))
                    t_fetch = time.perf_counter()
            finally:
                conn.close()
            db_s = time.perf_counter() - t_open
            if db_s > slowest_s:
                slowest, slowest_s = host, db_s

        with _span("fleet_scan.pack") as pk:
            states, counters, valid, truncated = _pack(names, seqs, max_samples)
            pk.set_attr("links", len(names))
            pk.set_attr("t_max", states.shape[1] if names else 0)
            pk.set_attr("truncated", len(truncated))
        # the per-link lists' teardown (a tenth of a microsecond a row) is
        # the loader's: free them inside its span, not on return
        del seqs
        for key, value in (("dbs", len(db_paths)), ("rows_fetched", fetched),
                           ("rows_tombstoned", tombstoned),
                           ("rows_kept", fetched - tombstoned), ("open_s", open_s),
                           ("fetch_s", fetch_s), ("slowest_db", slowest),
                           ("slowest_db_s", slowest_s)):
            sp.set_attr(key, value)
    return names, states, counters, valid, truncated


def _pack(names: List[str], seqs: Dict[str, List[Tuple[int, int]]], max_samples: int):
    """The loader's per-link sequences as left-aligned [L, T] arrays, each
    link cut to its latest ``max_samples``; returns (states, counters,
    valid, truncated)."""
    if not names:
        z = np.zeros((0, 1), dtype=np.int8)
        return z, z.astype(np.int32), z.astype(bool), []

    truncated: List[str] = []
    for name, seq in seqs.items():
        if len(seq) > max_samples:
            seqs[name] = seq[-max_samples:]  # keep the latest
            truncated.append(name)
    if truncated:
        logger.warning(
            "fleet-scan truncated %d link(s) to the latest %d samples "
            "(history denser than the array bound): %s",
            len(truncated), max_samples, ", ".join(sorted(truncated)[:5]),
        )
    t_max = max(len(seq) for seq in seqs.values())
    L = len(names)
    states = np.zeros((L, t_max), dtype=np.int8)
    counters = np.zeros((L, t_max), dtype=np.int32)
    valid = np.zeros((L, t_max), dtype=bool)
    for i, name in enumerate(names):
        seq = seqs[name]
        n = len(seq)
        states[i, :n] = [s for s, _c in seq]
        # rebase counters on the first sample: deltas are invariant and the
        # values stay in int32
        base = seq[0][1] if n else 0
        counters[i, :n] = np.clip(
            [c - base for _s, c in seq], -(2**31), 2**31 - 1
        )
        valid[i, :n] = True
    return states, counters, valid, truncated


def _scan_devices(device: DeviceLike) -> List[torch.device]:
    """The devices a scan splits its links over: every visible card for
    ``device=None`` on a host with more than one, else the one asked for."""
    if device is None and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def _classify_split(
    devices: List[torch.device],
    states: np.ndarray,
    counters: np.ndarray,
    valid: np.ndarray,
    flap_threshold: int = 3,
    crc_threshold: int = 100,
) -> np.ndarray:
    """Health class of every link, the links split into one block per
    device, as the reference shards them over its mesh.

    L is padded to a multiple of ``len(devices)`` with all-invalid rows
    (class 0, dropped after); block i of L/n rows is scanned and classified
    on ``devices[i]`` (one kernel launch per card), and the classes are
    gathered in link order. All blocks are launched before any is read.
    Recorded as the ``fleet_scan.split`` span, with the bytes copied to the
    devices.
    """
    n = len(devices)
    L = states.shape[0]
    with _span("fleet_scan.split", {"devices": n}) as sp:
        pad = (-L) % n
        if pad:
            states, counters, valid = (np.pad(x, ((0, pad), (0, 0)))
                                       for x in (states, counters, valid))
        rows = (L + pad) // n
        blocks = []
        h2d_bytes = 0
        for i, dev in enumerate(devices):
            part = slice(i * rows, (i + 1) * rows)
            arrays = (states[part], counters[part], valid[part])
            nbytes = sum(a.nbytes for a in arrays)
            h2d_bytes += nbytes
            with _span("fleet_scan.h2d", {"bytes": nbytes}):
                packed = packed_from_numpy(*arrays, dev)
            with _span("fleet_scan.scan", {"L": rows, "T": states.shape[1]}):
                scan = scan_links_packed(*packed)
            with _span("fleet_scan.classify"):
                blocks.append(classify_links(
                    scan, flap_threshold=flap_threshold, crc_threshold=crc_threshold))
        # the host waits here for every device's work
        with _span("fleet_scan.gather"):
            classes = torch.cat([b.cpu() for b in blocks])[:L].numpy()
        sp.set_attr("h2d_bytes", h2d_bytes)
    return classes


def fleet_scan(
    db_paths: List[str],
    window_seconds: float = DEFAULT_WINDOW_SECONDS,
    flap_threshold: int = 3,
    crc_threshold: int = 100,
    now: Optional[float] = None,
    device: DeviceLike = None,
) -> dict:
    """Scan the fleet's link history on ``device`` (the card by default;
    ``"cpu"`` only on request). With ``device=None`` on a host with more
    than one card, the links are split over every card
    (:func:`_classify_split`).

    Returns {"links": {name: "healthy|degraded|unhealthy"},
             "summary": {...}, "devices": n, "window_seconds": S,
             "truncated_links": [...]}; ``devices`` is the number of
    devices the scan ran on, 0 when there was nothing to scan.

    Recorded as the ``fleet_scan.sweep`` span, with the thread's CPU seconds.
    """
    cpu0 = time.thread_time()
    with _span("fleet_scan.sweep", {"dbs": len(db_paths)}) as sp:
        devices = _scan_devices(device)
        names, states, counters, valid, truncated = load_fleet_history(
            db_paths, window_seconds, now=now
        )
        summary = {label: 0 for label in CLASS_NAMES}
        out = {
            "window_seconds": window_seconds,
            "links": {},
            "summary": summary,
            "devices": 0,
            "truncated_links": truncated,
        }
        if names:
            classes = _classify_split(devices, states, counters, valid,
                                      flap_threshold, crc_threshold)
            with _span("fleet_scan.assemble"):
                out["devices"] = len(devices)
                for name, c in zip(names, classes.tolist()):
                    label = CLASS_NAMES[c]
                    out["links"][name] = label
                    summary[label] += 1
        sp.set_attr("links", len(names))
        sp.set_attr("devices", out["devices"])
        sp.set_attr("cpu_s", time.thread_time() - cpu0)
    return out
