"""The card's published peaks and the least time the scan's work can take.

The work is counted from what the sweep's inputs need, not from how the
program lays them out: every row of the window that survives the
tombstones is read once (an int8 state and an int32 counter, 5 bytes), and
each link's results are written once (five int64, 40 bytes). Padding and
layout do not count, so the bound stays the same whatever implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet, at its 700 W power limit
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "l2_bytes": 50 * 2**20,
    "power_limit_w": 700.0,
}

BYTES_PER_ROW = 5
BYTES_PER_LINK = 40


def scan_work_bytes(rows: int, links: int) -> int:
    return rows * BYTES_PER_ROW + links * BYTES_PER_LINK


def scan_bound_s(rows: int, links: int, peaks: dict = H100_SXM) -> float:
    """Least seconds for one scan: its work's bytes at the HBM rate."""
    return scan_work_bytes(rows, links) / peaks["hbm_bytes_per_s"]
