"""The fleet_faults generator: the same fleet for the same seed, another
for another seed, the same work for every seed, and each fault kind on
exactly its share of the links."""

import numpy as np
import pytest

from conftest import small_cell

from fleetbench import harness

SEED = 2**31 + 17  # more than 32 signed bits hold


def fleet(seed, name="su-hour"):
    cell = small_cell(name, hosts=None)
    return cell.generator.generate(cell.config, cell.traffic, seed, harness.NOW), cell


def arrays(f):
    return [(h.name, h.ts, h.states, h.crc, sorted(h.tombstones.items())) for h in f.hosts]


def same(a, b):
    return all(na == nb and np.array_equal(ta, tb) and np.array_equal(sa, sb)
               and np.array_equal(ca, cb) and xa == xb
               for (na, ta, sa, ca, xa), (nb, tb, sb, cb, xb) in zip(a, b))


def test_same_seed_same_fleet():
    assert same(arrays(fleet(SEED)[0]), arrays(fleet(SEED)[0]))


def test_other_seed_other_fleet_same_work():
    a, b = fleet(SEED)[0], fleet(SEED + 1)[0]
    assert not same(arrays(a), arrays(b))
    for key in ("rows_stored", "rows_window", "rows_scanned", "t_max", "links_total", "kinds"):
        assert getattr(a, key) == getattr(b, key), key


@pytest.mark.parametrize("seed", [0, 1, SEED, -5])
def test_shares_and_branches(seed):
    f, cell = fleet(seed)
    t = cell.traffic
    L = f.links_total
    assert L == 4608
    for kind in ("down", "flapping", "one_drop", "crc_hot", "crc_trickle", "counter_reset",
                 "edge_outside", "set_healthy"):
        share = t[f"links_{kind}_share"]
        n = f.kinds["link_set_healthy" if kind == "set_healthy" else kind]
        # exact counts: well inside what a binomial draw over 4608 links allows
        assert n == round(share * L) and abs(n - share * L) <= 3 * (share * L) ** 0.5 + 1
        assert n > 0
    assert f.kinds["set_healthy_host_faults"] == t["set_healthy_host_faulted_links"]
    assert f.kinds["edge_exact"] == t["edge_exact_links"]
    start = f.now - f.window_seconds
    stars = [h for h in f.hosts if "*" in h.tombstones]
    ragged = [h for h in f.hosts if len(h.ts) < max(len(x.ts) for x in f.hosts)]
    on_edge = [h for h in f.hosts if start in h.ts]
    assert len(stars) == t["hosts_set_healthy"] and len(ragged) == t["hosts_gap"]
    assert len(on_edge) == t["hosts_edge_phase"]
    resets = int(sum((np.diff(h.crc, axis=1) < 0).any(axis=1).sum() for h in f.hosts))
    assert resets >= f.kinds["counter_reset"] + f.kinds["rebooted_links"] // 2
    assert f.rows_scanned < f.rows_window < f.rows_stored
    assert f.t_max == int(f.window_seconds // cell.config["snapshot_interval_seconds"])


def test_superpod_scale():
    f, _cell = fleet(SEED, "superpod-hour")
    assert f.links_total == 127 * 144 == 18288
    assert len(f.hosts) == 127
