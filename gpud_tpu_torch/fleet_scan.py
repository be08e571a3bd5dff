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
                                     slowest_db, slowest_db_s, workers,
                                     wait_s, read_cpu_s, opens_on_workers
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
import time
from contextlib import contextmanager
from typing import Dict, List, Optional
from urllib.parse import quote

import numpy as np
import torch

from gpud_tpu_torch import tracing
from gpud_tpu_torch.device import DeviceLike, resolve_device
from gpud_tpu_torch.ops.packed_scan import packed_from_numpy, scan_links_packed
from gpud_tpu_torch.ops.window_scan import classify_links
from gpud_tpu_torch.snapshot_reader import TABLE, TOMBSTONE_TABLE, Block, Reads  # noqa: F401

logger = logging.getLogger(__name__)

DEFAULT_WINDOW_SECONDS = 3600.0
# dense-array bound: 14 days of minutes; a denser link keeps its latest
# samples and is reported as truncated
MAX_STEPS = 20160

CLASS_NAMES = ("healthy", "degraded", "unhealthy")

COMPONENT = "fleet_scan"  # the spans' component in the trace ring


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


class _FleetArrays:
    """The fleet's [L, T] int8 / int32 / bool arrays, each host's block
    copied in as its last DB is taken, so the blocks are never all held beside
    the fleet's arrays. Rows are added as hosts bring them, sized for the
    rows a host brought so far times the hosts, at least doubling; a wider
    block widens the arrays. Either copies the rows so far."""

    DTYPES = (np.int8, np.int32, bool)

    def __init__(self, n_hosts: int):
        self.n_hosts = n_hosts
        self.arrays = None
        self.rows = self.t = self.filled = self.placed = 0

    def place(self, rows: np.ndarray, blocks, n_rows: int) -> None:
        """Copy a host's blocks in at fleet rows ``rows``; the fleet has
        ``n_rows`` rows so far."""
        t = blocks[0].shape[1]
        self.placed += 1
        if not len(rows):
            return
        if n_rows > self.rows or t > self.t:
            cap = self.rows
            if n_rows > cap:
                cap = max(2 * cap, -(-n_rows * self.n_hosts // self.placed))
            self._resize(cap, max(t, self.t))
        for out, block in zip(self.arrays, blocks):
            out[rows, :t] = block
        self.filled = n_rows

    def _resize(self, rows: int, t: int) -> None:
        arrays = tuple(np.zeros((rows, t), dtype) for dtype in self.DTYPES)
        for new, old in zip(arrays, self.arrays or ()):
            new[:self.filled, :self.t] = old[:self.filled]
        self.arrays, self.rows, self.t = arrays, rows, t

    def result(self, n_rows: int):
        """The arrays, [n_rows, T]: T the widest block's, at least 1."""
        if self.t == 0:
            return tuple(np.zeros((n_rows, 1), dtype) for dtype in self.DTYPES)
        return tuple(a[:n_rows] for a in self.arrays)


def _number_rows(row_of: Dict[str, int], host: str, links: List[str]) -> None:
    """Fleet rows for a DB's links with kept samples, in name order, as
    ORDER BY link gave them: SQLite's BINARY collation of UTF-8 is code-point
    order. A row once taken is kept."""
    for link in sorted(links):
        row_of.setdefault(f"{host}/{link}", len(row_of))


def _place_block(fleet: _FleetArrays, row_of: Dict[str, int], host: str, block: Block,
                 max_samples: int) -> List[int]:
    """Copy a host's block into the fleet's arrays at the fleet rows of its
    links with kept samples; return the fleet rows of the links cut to
    ``max_samples``."""
    ids = np.flatnonzero(block.kept)
    arrays = (block.states, block.counters, block.valid)
    if len(ids) < len(block.names):  # a link whose samples a floor all dropped
        arrays = tuple(a[ids] for a in arrays)
    rows = np.array([row_of[f"{host}/{block.names[k]}"] for k in ids], np.intp)
    fleet.place(rows, arrays, len(row_of))
    return [row_of[f"{host}/{block.names[k]}"] for k in np.flatnonzero(block.kept > max_samples)]


def load_fleet_history(
    db_paths: List[str],
    window_seconds: float = DEFAULT_WINDOW_SECONDS,
    now: Optional[float] = None,
    max_samples: int = MAX_STEPS,
):
    """Read every host DB's snapshots in the window into packed arrays.

    Returns (names, states, counters, valid, truncated) where names[i]
    labels row i as ``<host>/<link>``, each DB's links in name order; arrays
    are numpy [L, T] (int8, int32, bool) with each link's samples
    left-aligned in ts order (``valid`` is a prefix mask). A link exceeding
    ``max_samples`` keeps its LATEST samples and is reported in
    ``truncated``, never silently.

    The DBs are read side by side by the native reader
    (snapshot_reader.py), as many worker threads as this process may use
    cores (none for one DB: it is read inline), each DB whole on one of
    them, and taken in DB order, so the output and the first failure are
    those of a read one DB at a time.
    Each DB's window is walked straight into its host's block; a host spread
    over several DBs (a DB whose stem is another's disambiguated name)
    continues one block over them. At each DB its links with kept samples
    take their fleet rows; at the host's last DB the block is copied into
    the fleet's arrays, and let go.

    Recorded as the ``fleet_scan.load`` span: rows fetched from SQLite,
    dropped by set-healthy tombstones and kept; seconds in the opens (open,
    tombstone read and floors, the host's block made) and in the reader's
    window walk with the DB's close, summed over the DBs, which overlap; the
    DB that took longest, from its open to the end of its array work; the
    workers (0 inline), the seconds this thread waited on the workers, the
    reads' thread CPU seconds, summed, and the DBs opened on a worker.
    """
    t_now = now if now is not None else time.time()
    start = t_now - window_seconds

    hosts: List[str] = []
    used_hosts: Dict[str, int] = {}
    for path in db_paths:
        host = os.path.splitext(os.path.basename(path))[0]
        # two DBs named host1.db in different dirs must not merge
        n_seen = used_hosts.get(host, 0)
        used_hosts[host] = n_seen + 1
        hosts.append(f"{host}-{n_seen + 1}" if n_seen else host)
    # read-only URIs; a path is escaped because '?', '#' or '%' would
    # otherwise be parsed as URI syntax
    uris = [f"file:{quote(os.path.abspath(path))}?mode=ro" for path in db_paths]
    workers = min(len(os.sched_getaffinity(0)), len(db_paths))

    row_of: Dict[str, int] = {}  # name → fleet row, in the order first kept
    # a DB whose own stem is another's disambiguated name shares its host:
    # its rows join that host's links, after the earlier DB's
    fleet = _FleetArrays(len(set(hosts)))
    cut_rows: List[int] = []
    fetched = tombstoned = 0
    open_s = fetch_s = read_cpu_s = wait_s = slowest_s = 0.0
    slowest, on_workers = "", 0
    with _span("fleet_scan.load") as sp:
        with Reads(uris, hosts, start, max_samples, workers) as reads:
            for i, host in enumerate(hosts):
                read = reads.take(i)
                t_rest = time.perf_counter()
                fetched += read.fetched
                tombstoned += read.tombstoned
                open_s += read.open_s
                fetch_s += read.fetch_s
                read_cpu_s += read.cpu_s
                wait_s += read.wait_s
                on_workers += read.on_worker
                _number_rows(row_of, host, read.links)
                if read.block is not None:
                    cut_rows += _place_block(fleet, row_of, host, read.block, max_samples)
                db_s = read.open_s + read.fetch_s + time.perf_counter() - t_rest
                if db_s > slowest_s:
                    slowest, slowest_s = host, db_s
                del read  # the block's pages go back now
            n_workers = reads.workers

        with _span("fleet_scan.pack") as pk:
            names = list(row_of)
            states, counters, valid = fleet.result(len(names))
            t_max = states.shape[1]
            truncated = [names[r] for r in sorted(cut_rows)]
            if truncated:
                logger.warning(
                    "fleet-scan truncated %d link(s) to the latest %d samples "
                    "(history denser than the array bound): %s",
                    len(truncated), max_samples, ", ".join(sorted(truncated)[:5]),
                )
            pk.set_attr("links", len(names))
            pk.set_attr("t_max", t_max if names else 0)
            pk.set_attr("truncated", len(truncated))
        for key, value in (("dbs", len(db_paths)), ("rows_fetched", fetched),
                           ("rows_tombstoned", tombstoned),
                           ("rows_kept", fetched - tombstoned), ("open_s", open_s),
                           ("fetch_s", fetch_s), ("slowest_db", slowest),
                           ("slowest_db_s", slowest_s),
                           ("workers", n_workers), ("wait_s", wait_s),
                           ("read_cpu_s", read_cpu_s), ("opens_on_workers", on_workers)):
            sp.set_attr(key, value)
    return names, states, counters, valid, truncated


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
