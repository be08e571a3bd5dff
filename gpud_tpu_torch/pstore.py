"""pstore crash-log reader.

Reference: pkg/pstore/pstore.go:19-50 — reads kernel crash dumps that
systemd-pstore moved to /var/lib/systemd/pstore after a reboot, records
them into a SQLite history table (schema v0_7_0 there) so the os component
can attribute a reboot to a kernel panic.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import List, Optional

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.sqlite import DB

logger = get_logger(__name__)

DEFAULT_PSTORE_DIR = "/var/lib/systemd/pstore"
ENV_PSTORE_DIR = "TPUD_PSTORE_DIR"
TABLE = "tpud_pstore_v0_1"

# dmesg-style crash files written by the kernel's pstore backend
_CRASH_FILE_RE = re.compile(r"(dmesg|console)-.*", re.IGNORECASE)
_PANIC_RE = re.compile(
    r"(Kernel panic|BUG:|Oops:|general protection fault|watchdog: hard LOCKUP)",
    re.IGNORECASE,
)


@dataclass
class CrashRecord:
    path: str
    mtime: float
    kind: str        # panic | oops | unknown
    excerpt: str     # first matching lines


def pstore_dir(override: str = "") -> str:
    return override or os.environ.get(ENV_PSTORE_DIR, "") or DEFAULT_PSTORE_DIR


def read_crash_files(dir_path: str = "", max_bytes: int = 1 << 20) -> List[CrashRecord]:
    """Scan the pstore dir for crash dumps (reference: pstore.go:19-50)."""
    d = pstore_dir(dir_path)
    out: List[CrashRecord] = []
    if not os.path.isdir(d):
        return out
    for root, _dirs, files in os.walk(d):
        for name in files:
            if not _CRASH_FILE_RE.match(name):
                continue
            path = os.path.join(root, name)
            try:
                st = os.stat(path)
                with open(path, "r", encoding="utf-8", errors="replace") as f:
                    content = f.read(max_bytes)
            except OSError:
                continue
            kind = "unknown"
            excerpt_lines = []
            for ln in content.splitlines():
                if _PANIC_RE.search(ln):
                    excerpt_lines.append(ln.strip())
                    if "panic" in ln.lower():
                        kind = "panic"
                    elif kind == "unknown":
                        kind = "oops"
                if len(excerpt_lines) >= 5:
                    break
            out.append(
                CrashRecord(
                    path=path,
                    mtime=st.st_mtime,
                    kind=kind,
                    excerpt="\n".join(excerpt_lines) or content[:500].strip(),
                )
            )
    return sorted(out, key=lambda r: r.mtime)


class PstoreHistory:
    """SQLite history of observed crash dumps, deduped by path+mtime so a
    dump is reported once across daemon restarts."""

    def __init__(self, db: DB) -> None:
        self.db = db
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                path TEXT NOT NULL,
                mtime REAL NOT NULL,
                kind TEXT NOT NULL,
                excerpt TEXT,
                recorded_at REAL NOT NULL,
                PRIMARY KEY (path, mtime)
            )"""
        )

    def record_new(self, records: List[CrashRecord]) -> List[CrashRecord]:
        """Insert unseen records; returns only the new ones."""
        fresh = []
        for r in records:
            row = self.db.query_one(
                f"SELECT 1 FROM {TABLE} WHERE path=? AND mtime=?",
                (r.path, r.mtime),
            )
            if row is not None:
                continue
            self.db.execute(
                f"INSERT INTO {TABLE} (path, mtime, kind, excerpt, recorded_at) "
                "VALUES (?, ?, ?, ?, ?)",
                (r.path, r.mtime, r.kind, r.excerpt, time.time()),
            )
            fresh.append(r)
        return fresh

    def all(self) -> List[CrashRecord]:
        return [
            CrashRecord(path=p, mtime=m, kind=k, excerpt=e)
            for p, m, k, e in self.db.query(
                f"SELECT path, mtime, kind, excerpt FROM {TABLE} ORDER BY mtime"
            )
        ]
