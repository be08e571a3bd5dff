"""Link histories of a fleet of hosts with seeded faults, one DB per host.

Every link of every host has one snapshot per sweep interval over the
window and the older history kept before it. Each fault kind takes an exact
number of links (its share of the fleet, rounded), placed by a permutation
drawn from the seed, so every seed does the same work: the same rows, the
same classes in the same numbers up to the drawn transitions, on other
links. The kinds are chosen so that every health class and every branch of
the loader occurs in every sweep:

- ``down``: down at the window's end;
- ``flapping``: 2 to 8 transitions inside the window;
- ``one_drop``: one drop and one recovery inside the window;
- ``crc_hot``: a CRC increase at or above the class threshold in the window;
- ``crc_trickle``: a small increase in the window, a large one before it
  (the window edge: only the first counts);
- ``counter_reset``: the CRC counter drops to a small value mid-window;
- ``edge_outside``: down at every sample before the window, up inside it;
- a host set healthy (a ``*`` tombstone) mid-window, with faults before it;
- links set healthy one by one (per-link tombstones) after a fault;
- a rebooted host: sweeps missing, then every counter from near zero;
- a host whose sweeps fall on whole minutes, so one sample lies exactly on
  the window's start, with links down at that sample alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

# order in which the share kinds take links from the permutation
SHARE_KINDS = ("down", "flapping", "one_drop", "crc_hot", "crc_trickle",
               "counter_reset", "edge_outside")


@dataclass
class Host:
    name: str
    links: List[str]
    ts: np.ndarray          # [sweeps] float64
    states: np.ndarray      # [links, sweeps] int8, 1 = up
    crc: np.ndarray         # [links, sweeps] int64
    tombstones: Dict[str, float] = field(default_factory=dict)


@dataclass
class Fleet:
    hosts: List[Host]
    now: float
    window_seconds: float
    links_total: int
    rows_stored: int
    rows_window: int        # rows at or after the window's start
    rows_scanned: int       # of those, the rows no tombstone masks
    t_max: int              # most rows of one link the scan gets
    kinds: Dict[str, int]   # links per fault kind


def _draw(rng, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi + 1))


def _parts(rng, total: int, k: int) -> List[int]:
    """``total`` split into ``min(k, total)`` positive whole parts."""
    k = max(1, min(k, total))
    cuts = np.sort(rng.choice(np.arange(1, total), size=k - 1, replace=False)) \
        if k > 1 else np.array([], dtype=np.int64)
    return np.diff(np.concatenate([[0], cuts, [total]])).astype(int).tolist()


def _positions(rng, lo: int, hi: int, k: int) -> List[int]:
    """``k`` distinct sorted positions in [lo, hi]."""
    return sorted(rng.choice(np.arange(lo, hi + 1), size=k, replace=False).tolist())


def generate(config: dict, traffic: dict, seed: int, now: float) -> Fleet:
    rng = np.random.default_rng(seed & (2**64 - 1))
    hosts_n = config["hosts"]
    per_host = config["gpus_per_host"] * config["nvlink_links_per_gpu"]
    links = [f"gpu{g}/nvlink{k}" for g in range(config["gpus_per_host"])
             for k in range(config["nvlink_links_per_gpu"])]
    step = float(config["snapshot_interval_seconds"])
    window = float(traffic["window_seconds"])
    stored = window + config["history_before_window_seconds"]
    slots = int(stored // step)
    start = now - window
    L = hosts_n * per_host

    special = rng.permutation(hosts_n)
    n_special = traffic["hosts_set_healthy"] + traffic["hosts_gap"] + traffic["hosts_edge_phase"]
    if n_special > hosts_n:
        raise ValueError(f"{n_special} special hosts for a fleet of {hosts_n}")
    set_healthy_hosts = set(special[:traffic["hosts_set_healthy"]].tolist())
    rest = special[traffic["hosts_set_healthy"]:]
    gap_hosts = set(rest[:traffic["hosts_gap"]].tolist())
    edge_hosts = set(rest[traffic["hosts_gap"]:n_special - traffic["hosts_set_healthy"]].tolist())

    # share kinds: disjoint sets of links, taken in turn from one permutation
    kind = np.full(L, "", dtype=object)
    order = rng.permutation(L)
    taken = 0
    counts: Dict[str, int] = {}
    for k in SHARE_KINDS:
        n = int(round(traffic[f"links_{k}_share"] * L))
        kind[order[taken:taken + n]] = k
        counts[k] = n
        taken += n
    # per-link tombstones on free links of ordinary hosts
    ordinary = np.array([i for i in order[taken:]
                         if i // per_host not in set_healthy_hosts | gap_hosts | edge_hosts],
                        dtype=np.int64)
    n = int(round(traffic["links_set_healthy_share"] * L))
    kind[ordinary[:n]] = "link_set_healthy"
    counts["link_set_healthy"] = n

    hosts: List[Host] = []
    rows_stored = rows_window = rows_scanned = t_max = 0
    counts.update(set_healthy_host_faults=0, edge_exact=0, rebooted_links=0)
    for h in range(hosts_n):
        age = (traffic["edge_phase_newest_age_seconds"] if h in edge_hosts
               else config["newest_snapshot_age_seconds"])
        ts = now - age - step * np.arange(slots - 1, -1, -1, dtype=np.float64)
        w0 = int(np.searchsorted(ts, start, side="left"))  # first slot in the window
        W = slots - w0
        states = np.ones((per_host, slots), dtype=np.int8)
        crc = rng.integers(0, config["crc_base_max"] + 1, size=(per_host, 1)) \
            + np.zeros((1, slots), dtype=np.int64)
        tombstones: Dict[str, float] = {}

        def bump(i, pos, amount):
            crc[i, w0 + pos:] += amount

        host_kinds = kind[h * per_host:(h + 1) * per_host]
        for i, k in enumerate(host_kinds):
            if k == "down":
                states[i, w0 + int(rng.integers(0, W)):] = 0
            elif k == "flapping":
                for p in _positions(rng, 1, W - 1, _draw(rng, traffic["flapping_transitions"])):
                    states[i, w0 + p:] ^= 1
            elif k == "one_drop":
                n_down = _draw(rng, traffic["one_drop_samples"])
                p = int(rng.integers(1, W - n_down))
                states[i, w0 + p:w0 + p + n_down] = 0
            elif k == "crc_hot":
                parts = _parts(rng, _draw(rng, traffic["crc_hot_increase"]), _draw(rng, (1, 5)))
                for p, x in zip(_positions(rng, 1, W - 1, len(parts)), parts):
                    bump(i, p, x)
            elif k == "crc_trickle":
                parts = _parts(rng, _draw(rng, traffic["crc_trickle_increase"]), _draw(rng, (1, 3)))
                for p, x in zip(_positions(rng, 1, W - 1, len(parts)), parts):
                    bump(i, p, x)
                bump(i, int(rng.integers(1 - w0, 0)), _draw(rng, traffic["crc_before_window_increase"]))
            elif k == "counter_reset":
                r = int(rng.integers(2, W - 1))
                bump(i, int(rng.integers(1, r)), _draw(rng, traffic["counter_reset_increase"]))
                crc[i, w0 + r:] = _draw(rng, traffic["counter_reset_value"])
                bump(i, int(rng.integers(r + 1, W)), _draw(rng, traffic["counter_reset_increase"]))
            elif k == "edge_outside":
                states[i, :w0] = 0
            elif k == "link_set_healthy":
                t = int(round(traffic["link_set_healthy_at"] * W))
                n_down = _draw(rng, traffic["one_drop_samples"])
                p = int(rng.integers(1, t - n_down))
                states[i, w0 + p:w0 + p + n_down] = 0
                bump(i, int(rng.integers(1, t)), _draw(rng, traffic["crc_hot_increase"]))
                tombstones[links[i]] = float(ts[w0 + t])

        free = [i for i, k in enumerate(host_kinds) if k == ""]
        if h in set_healthy_hosts:
            # set healthy at mid-window, after faults on some of its links
            t = int(round(traffic["host_set_healthy_at"] * W))
            tombstones["*"] = float(ts[w0 + t])
            picked = rng.choice(free, size=traffic["set_healthy_host_faulted_links"], replace=False)
            for j, i in enumerate(sorted(picked.tolist())):
                if j % 3 == 0:  # down, back up at the tombstone's sample
                    states[i, w0 + int(rng.integers(0, t - 1)):w0 + t] = 0
                elif j % 3 == 1:  # flapping, ending up before the tombstone
                    n_t = 2 * _draw(rng, (1, 4))
                    for p in _positions(rng, 1, t - 1, n_t):
                        states[i, w0 + p:] ^= 1
                else:
                    bump(i, int(rng.integers(1, t)), _draw(rng, traffic["crc_hot_increase"]))
            counts["set_healthy_host_faults"] += len(picked)
        if h in edge_hosts:
            # down at the sample that lies exactly on the window's start
            if ts[w0] != start:
                raise ValueError("the edge host's sweeps miss the window's start")
            picked = rng.choice(free, size=traffic["edge_exact_links"], replace=False)
            states[picked, w0] = 0
            counts["edge_exact"] += len(picked)
        keep = np.ones(slots, dtype=bool)
        if h in gap_hosts:
            # a reboot: sweeps missing, then every counter from near zero
            g = int(rng.integers(1, W - traffic["gap_sweeps"]))
            back = w0 + g + traffic["gap_sweeps"]
            keep[w0 + g:back] = False
            lo, hi = traffic["counter_reset_value"]
            restart = rng.integers(lo, hi + 1, size=(per_host, 1))
            crc[:, back:] = restart + crc[:, back:] - crc[:, back:back + 1]
            counts["rebooted_links"] += per_host

        ts, states, crc = ts[keep], states[:, keep], crc[:, keep]
        in_window = ts >= start
        rows_stored += states.size
        rows_window += per_host * int(in_window.sum())
        for i, ln in enumerate(links):
            tomb = max(tombstones.get("*", 0.0), tombstones.get(ln, 0.0))
            n = int((in_window & (ts >= tomb)).sum())
            rows_scanned += n
            t_max = max(t_max, n)
        hosts.append(Host(f"dgx{h:03d}", links, ts, states, crc, tombstones))

    return Fleet(hosts=hosts, now=now, window_seconds=window, links_total=L,
                 rows_stored=rows_stored, rows_window=rows_window,
                 rows_scanned=rows_scanned, t_max=t_max, kinds=counts)
