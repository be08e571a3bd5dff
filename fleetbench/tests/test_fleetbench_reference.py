"""The plain reference on small hand-built DBs, one per fault kind and
tombstone case, each with the class the link store's rules give."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fleetbench.reference import fleet as reference  # noqa: E402
from fleetbench.store import write_host_db  # noqa: E402

NOW = 1_000_000.0
WINDOW = 600.0  # ten 60 s samples: ts = NOW - 570, ..., NOW - 30


def ts_grid(n=20, age=30.0):
    """n samples a minute apart, the newest ``age`` seconds old."""
    return NOW - age - 60.0 * np.arange(n - 1, -1, -1)


def up(n=20):
    return np.ones(n, dtype=np.int8)


def flat(n=20, base=1000):
    return np.full(n, base, dtype=np.int64)


def with_(a, idx, value):
    a = a.copy()
    a[idx] = value
    return a


def steps(base, at, amounts, n=20):
    c = flat(n, base)
    for i, x in zip(at, amounts):
        c[i:] += x
    return c


# case: (states, crc, tombstones, ts, expected class or None for unreported)
CASES = {
    "healthy": (up(), flat(), {}, None, "healthy"),
    "down_at_end": (with_(up(), slice(17, None), 0), flat(), {}, None, "unhealthy"),
    "one_drop": (with_(up(), slice(13, 15), 0), flat(), {}, None, "degraded"),
    "two_transitions_ending_down": (with_(up(), slice(15, None), 0), flat(), {}, None, "unhealthy"),
    "flapping_three_drops": (with_(up(), [11, 13, 15], 0), flat(), {}, None, "unhealthy"),
    "drop_before_window": (with_(up(), slice(2, 5), 0), flat(), {}, None, "healthy"),
    "crc_at_threshold": (up(), steps(7, [12, 16], [60, 40]), {}, None, "degraded"),
    "crc_below_threshold": (up(), steps(7, [12, 16], [60, 39]), {}, None, "healthy"),
    "crc_before_window": (up(), steps(7, [3], [5000]), {}, None, "healthy"),
    "crc_on_the_edge_pair": (up(), steps(7, [10], [5000]), {}, None, "healthy"),
    "counter_reset_small": (up(), with_(steps(900, [12], [40]), slice(15, None), 3), {}, None,
                            "healthy"),
    "counter_reset_adds_up": (up(), with_(steps(900, [12], [60]), slice(15, None),
                                          np.array([3, 3, 50, 50, 50])), {}, None, "degraded"),
    "host_set_healthy_after_faults": (with_(up(), [11, 13], 0), steps(7, [12], [500]),
                                      {"*": NOW - 30 - 60 * 5}, None, "healthy"),
    "host_set_healthy_then_fault": (with_(up(), [17], 0), flat(),
                                    {"*": NOW - 30 - 60 * 5}, None, "degraded"),
    "link_set_healthy_after_fault": (with_(up(), slice(11, 14), 0), flat(),
                                     {"gpu0/nvlink0": NOW - 30 - 60 * 5}, None, "healthy"),
    "tombstone_on_a_sample_keeps_it": (with_(up(), 14, 0), flat(),
                                       {"gpu0/nvlink0": NOW - 30 - 60 * 5}, None, "degraded"),
    "other_link_tombstone_ignored": (with_(up(), [12], 0), flat(),
                                     {"gpu0/nvlink1": NOW - 30 - 60 * 3}, None, "degraded"),
    "fully_masked": (with_(up(), 19, 0), flat(), {"*": NOW + 1}, None, None),
    # newest sample 0 s old: sample 9 lies exactly on the window's start
    "edge_sample_counts": (with_(up(), 9, 0), flat(), {}, ts_grid(age=0.0), "degraded"),
    # four sweeps missing, then the counter from near zero
    "gap_then_reset": (up(16), with_(flat(16, 90_000), slice(12, None), 1), {},
                       np.delete(ts_grid(), [12, 13, 14, 15]), "healthy"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_class(tmp_path, case):
    states, crc, tombs, ts, want = CASES[case]
    ts = ts_grid(len(states)) if ts is None else ts
    path = tmp_path / "host.db"
    write_host_db(str(path), ["gpu0/nvlink0"], ts, states[None, :], crc[None, :], tombs)
    got = reference.sweep([str(path)], WINDOW, NOW)
    if want is None:
        assert got["links"] == {}
    else:
        assert got["links"] == {"host/gpu0/nvlink0": want}
    assert sum(got["summary"].values()) == len(got["links"])


def test_reference_truncates_to_the_latest(tmp_path):
    path = tmp_path / "host.db"
    states = with_(up(), 12, 0)  # a drop among the older samples of the window
    write_host_db(str(path), ["gpu0/nvlink0"], ts_grid(), states[None, :], flat()[None, :], {})
    full = reference.sweep([str(path)], WINDOW, NOW)
    cut = reference.sweep([str(path)], WINDOW, NOW, max_samples=5)
    assert full["links"]["host/gpu0/nvlink0"] == "degraded" and full["truncated_links"] == []
    assert cut["links"]["host/gpu0/nvlink0"] == "healthy"
    assert cut["truncated_links"] == ["host/gpu0/nvlink0"]


def test_reference_names_repeated_stems(tmp_path):
    paths = []
    for i, sub in enumerate(("a", "b")):
        (tmp_path / sub).mkdir()
        path = tmp_path / sub / "node.db"
        states = up() if i == 0 else with_(up(), 19, 0)
        write_host_db(str(path), ["gpu0/nvlink0"], ts_grid(), states[None, :], flat()[None, :], {})
        paths.append(str(path))
    got = reference.sweep(paths, WINDOW, NOW)
    assert got["links"] == {"node/gpu0/nvlink0": "healthy", "node-2/gpu0/nvlink0": "unhealthy"}
    assert got["summary"] == {"healthy": 1, "degraded": 0, "unhealthy": 1}


def test_control_ignores_tombstones(tmp_path):
    states, crc, tombs, _ts, _want = CASES["host_set_healthy_after_faults"]
    path = tmp_path / "host.db"
    write_host_db(str(path), ["gpu0/nvlink0"], ts_grid(), states[None, :], crc[None, :], tombs)
    got = reference.sweep([str(path)], WINDOW, NOW, tombstones=False)
    assert got["links"] == {"host/gpu0/nvlink0": "degraded"}
