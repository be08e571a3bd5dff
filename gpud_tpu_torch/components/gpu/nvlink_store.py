"""NVLink link time-series store.

The port of ``gpud_tpu/components/tpu/ici_store.py``, the analog of the
InfiniBand component's dedicated SQLite store
(reference: components/accelerator/nvidia/infiniband/store/interface.go:9-36):
per-port snapshots over a long horizon, scanned for link drops and flaps,
with tombstones so an admin action (set-healthy) makes the scan ignore
history before a point in time.

Snapshot rows are (ts, link, state, counters...); the scan computes per-link:
- ``currently_down``: latest snapshot has state down,
- ``drops``: up→down transitions inside the window,
- ``flaps``: down→up recoveries inside the window (a drop that recovers),
- counter deltas (CRC errors etc.) across the window.

The tables keep the reference's names and schema, so the rows this store
writes are what ``fleet_scan`` reads (this package's and ``gpud_tpu``'s).
The scan is the pure-Python walk; the reference's native ragged scan comes
with the native library, in the device-free daemon's slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from gpud_tpu_torch.gpu.instance import LinkState, NVLinkSnapshot
from gpud_tpu_torch.sqlite import DB

TABLE = "tpud_ici_snapshots_v0_1"
TOMBSTONE_TABLE = "tpud_ici_tombstones_v0_1"

DEFAULT_RETENTION = 14 * 86400


@dataclass
class LinkScan:
    link: str
    currently_down: bool = False
    drops: int = 0
    flaps: int = 0
    crc_delta: int = 0
    error_delta: int = 0
    last_state: str = LinkState.UNKNOWN
    last_seen: float = 0.0
    first_seen: float = 0.0
    samples: int = 0


@dataclass
class ScanResult:
    window_start: float
    links: Dict[str, LinkScan] = field(default_factory=dict)

    @property
    def down_links(self) -> List[str]:
        return sorted(k for k, v in self.links.items() if v.currently_down)

    @property
    def flapping_links(self) -> List[str]:
        return sorted(k for k, v in self.links.items() if v.flaps > 0)

    @property
    def dropped_links(self) -> List[str]:
        return sorted(k for k, v in self.links.items() if v.drops > 0)


class NVLinkStore:
    def __init__(self, db: DB, retention_seconds: int = DEFAULT_RETENTION) -> None:
        self.db = db
        self.retention_seconds = retention_seconds
        self.time_now_fn = time.time
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                ts REAL NOT NULL,
                link TEXT NOT NULL,
                state INTEGER NOT NULL,
                tx_bytes INTEGER NOT NULL DEFAULT 0,
                rx_bytes INTEGER NOT NULL DEFAULT 0,
                tx_errors INTEGER NOT NULL DEFAULT 0,
                rx_errors INTEGER NOT NULL DEFAULT 0,
                crc_errors INTEGER NOT NULL DEFAULT 0,
                replays INTEGER NOT NULL DEFAULT 0
            )"""
        )
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_link_ts ON {TABLE} (link, ts)"
        )
        # bare-ts index so purge's DELETE ... WHERE ts<? doesn't full-scan
        db.execute(f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_ts ON {TABLE} (ts)")
        db.execute(
            f"CREATE TABLE IF NOT EXISTS {TOMBSTONE_TABLE} "
            "(link TEXT PRIMARY KEY, ts REAL NOT NULL)"
        )

    # -- writes ------------------------------------------------------------
    def insert_snapshot(
        self, links: List[NVLinkSnapshot], ts: Optional[float] = None
    ) -> None:
        t = ts if ts is not None else self.time_now_fn()
        self.db.executemany(
            f"INSERT INTO {TABLE} (ts, link, state, tx_bytes, rx_bytes, "
            "tx_errors, rx_errors, crc_errors, replays) VALUES (?,?,?,?,?,?,?,?,?)",
            [
                (
                    t,
                    ln.name,
                    1 if ln.state == LinkState.UP else 0,
                    ln.tx_bytes,
                    ln.rx_bytes,
                    ln.tx_errors,
                    ln.rx_errors,
                    ln.crc_errors,
                    ln.replays,
                )
                for ln in links
            ],
        )

    def purge(self, before: Optional[float] = None) -> int:
        cutoff = (
            before
            if before is not None
            else self.time_now_fn() - self.retention_seconds
        )
        return self.db.execute(f"DELETE FROM {TABLE} WHERE ts<?", (cutoff,)).rowcount

    # -- tombstones (reference: IB store tombstone on admin action) --------
    def set_tombstone(self, link: str = "*", ts: Optional[float] = None) -> None:
        """``link='*'`` tombstones all links (set-healthy semantics)."""
        t = ts if ts is not None else self.time_now_fn()
        self.db.execute(
            f"INSERT INTO {TOMBSTONE_TABLE} (link, ts) VALUES (?, ?) "
            "ON CONFLICT(link) DO UPDATE SET ts=excluded.ts",
            (link, t),
        )

    def tombstones(self) -> Dict[str, float]:
        """All tombstones as link→ts (one query per scan, not per link)."""
        return {
            r[0]: r[1]
            for r in self.db.query(f"SELECT link, ts FROM {TOMBSTONE_TABLE}")
        }

    def tombstone_for(self, link: str) -> float:
        t = self.tombstones()
        return max(t.get("*", 0.0), t.get(link, 0.0))

    # -- scan --------------------------------------------------------------
    def scan(self, window_seconds: float) -> ScanResult:
        """Walk each link's snapshots in the window (post-tombstone) and
        classify drops/flaps (reference: IB store Scan marks drops/flaps)."""
        now = self.time_now_fn()
        start = now - window_seconds
        res = ScanResult(window_start=start)
        rows = self.db.query(
            f"SELECT link, ts, state, tx_errors, rx_errors, crc_errors "
            f"FROM {TABLE} WHERE ts>=? ORDER BY link, ts ASC",
            (start,),
        )
        all_tombstones = self.tombstones()
        global_tombstone = all_tombstones.get("*", 0.0)

        # group per link, dropping tombstone-masked rows up front
        order: List[str] = []
        seqs: Dict[str, list] = {}
        tombstone = 0.0
        cur_link: Optional[str] = None
        for link, ts, state, tx_err, rx_err, crc in rows:
            if link != cur_link:
                cur_link = link
                tombstone = max(global_tombstone, all_tombstones.get(link, 0.0))
                if link not in seqs:
                    order.append(link)
                    seqs[link] = []
            if ts < tombstone:
                continue
            seqs[link].append((ts, state, tx_err + rx_err, crc))
        # links fully masked by a tombstone end up with zero samples — drop
        # them so they don't read as "down since forever"
        order = [l for l in order if seqs[l]]

        classified = self._classify_python(order, seqs)

        for link in order:
            seq = seqs[link]
            drops, flaps, currently_down, error_delta, crc_delta = classified[link]
            res.links[link] = LinkScan(
                link=link,
                currently_down=currently_down,
                drops=drops,
                flaps=flaps,
                crc_delta=crc_delta,
                error_delta=error_delta,
                last_state=LinkState.UP if seq[-1][1] == 1 else LinkState.DOWN,
                last_seen=seq[-1][0],
                first_seen=seq[0][0],
                samples=len(seq),
            )
        return res

    def _classify_python(self, order: List[str], seqs: Dict[str, list]) -> Dict[str, tuple]:
        out: Dict[str, tuple] = {}
        for link in order:
            drops = flaps = error_delta = crc_delta = 0
            prev_state: Optional[int] = None
            prev_err: Optional[int] = None
            prev_crc: Optional[int] = None
            state = 1
            for _ts, state, err, crc in seqs[link]:
                if prev_err is not None:
                    # accumulate only positive steps: counters are monotonic
                    # in hardware but may reset on driver reload/reboot
                    error_delta += max(0, err - prev_err)
                    crc_delta += max(0, crc - prev_crc)
                prev_err, prev_crc = err, crc
                if prev_state is not None:
                    if prev_state == 1 and state == 0:
                        drops += 1
                    elif prev_state == 0 and state == 1:
                        flaps += 1
                prev_state = state
            out[link] = (drops, flaps, state == 0, error_delta, crc_delta)
        return out

    def link_names(self) -> List[str]:
        return [r[0] for r in self.db.query(f"SELECT DISTINCT link FROM {TABLE}")]
