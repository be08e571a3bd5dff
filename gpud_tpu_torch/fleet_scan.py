"""Fleet-wide link-history scan on the card.

Counterpart of ``gpud_tpu/fleet_scan.py``. Per-host daemons keep 14 days of
per-link snapshots in their state DBs (``tpud_ici_snapshots_v0_1``, written
by ``ICIStore``). An operator sweeps every host's history at once: the
fleet's history packs into [L, T] arrays, one CUDA kernel scans every link
(``ops/packed_scan.py``), and the health classes follow on the same device.

Entry point: ``python -m gpud_tpu_torch fleet-scan host1.db host2.db ...``.
Each DB is opened read-only; link names are prefixed with the DB's stem
(disambiguated when two DBs share a filename) and set-healthy tombstones
are honoured exactly like the per-host scan.

Histories are packed: each link's snapshots sit left-aligned in ts order
with suffix padding (a prefix validity mask), so every consecutive snapshot
pair is compared exactly like ``ICIStore.scan`` walks them. Per-link sample
counts are bounded by ``MAX_STEPS`` (14 days of minutes).
"""

from __future__ import annotations

import logging
import os
import sqlite3
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote

import numpy as np

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
    """
    t_now = now if now is not None else time.time()
    start = t_now - window_seconds

    seqs: Dict[str, List[Tuple[int, int]]] = {}  # name → [(state, crc), ...]
    names: List[str] = []
    used_hosts: Dict[str, int] = {}
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
            cur = conn.execute(
                f"SELECT link, ts, state, crc_errors FROM {TABLE} "
                "WHERE ts>=? ORDER BY link, ts ASC",
                (start,),
            )
            for link, ts, state, crc in cur:
                # honour set-healthy exactly like ICIStore.scan
                if ts < max(global_ts, tombstones.get(link, 0.0)):
                    continue
                name = f"{host}/{link}"
                if name not in seqs:
                    seqs[name] = []
                    names.append(name)
                seqs[name].append((int(state), int(crc)))
        finally:
            conn.close()

    if not names:
        z = np.zeros((0, 1), dtype=np.int8)
        return [], z, z.astype(np.int32), z.astype(bool), []

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
    return names, states, counters, valid, truncated


def fleet_scan(
    db_paths: List[str],
    window_seconds: float = DEFAULT_WINDOW_SECONDS,
    flap_threshold: int = 3,
    crc_threshold: int = 100,
    now: Optional[float] = None,
    device: DeviceLike = None,
) -> dict:
    """Scan the fleet's link history on ``device`` (the card by default;
    ``"cpu"`` only on request).

    Returns {"links": {name: "healthy|degraded|unhealthy"},
             "summary": {...}, "devices": n, "window_seconds": S,
             "truncated_links": [...]}; ``devices`` is 1 when a scan ran.
    """
    dev = resolve_device(device)
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
    if not names:
        return out

    scan = scan_links_packed(*packed_from_numpy(states, counters, valid, dev))
    classes = classify_links(
        scan, flap_threshold=flap_threshold, crc_threshold=crc_threshold
    ).tolist()
    out["devices"] = 1
    for name, c in zip(names, classes):
        label = CLASS_NAMES[c]
        out["links"][name] = label
        summary[label] += 1
    return out
