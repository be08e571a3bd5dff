"""The port's NVLink store (gpud_tpu_torch/components/gpu/nvlink_store.py)
against the reference's ICIStore (gpud_tpu/components/tpu/ici_store.py).

The port's store keeps the reference's tables and schema: rows it writes are
scanned by ``ICIStore.scan`` (pure-Python walk, ``native_enabled=False``) over
the same DB with results equal to ``NVLinkStore.scan``, and classified by
``gpud_tpu.fleet_scan`` (JAX on the CPU) and ``gpud_tpu_torch.fleet_scan``
(``device="cpu"``) with identical classes. The store-level cases of
tests/test_ici.py run through both stores."""

import numpy as np
import pytest

from gpud_tpu import fleet_scan as jax_fs
from gpud_tpu.components.tpu.ici_store import TABLE as REF_TABLE
from gpud_tpu.components.tpu.ici_store import TOMBSTONE_TABLE as REF_TOMBSTONES
from gpud_tpu.components.tpu.ici_store import ICIStore
from gpud_tpu.sqlite import DB as RefDB
from gpud_tpu.tpu.instance import ICILinkSnapshot

from gpud_tpu_torch import fleet_scan as torch_fs
from gpud_tpu_torch.components.gpu.nvlink_store import TABLE, TOMBSTONE_TABLE, NVLinkStore
from gpud_tpu_torch.gpu.instance import LinkState, NVLinkSnapshot
from gpud_tpu_torch.sqlite import DB

from torch_parity import link_name, port_link

NOW = 1_700_000_000.0


def _links(n_down=(), crc=0, chips=2, per_chip=4):
    return [NVLinkSnapshot(gpu_id=g, link_id=k,
                           state=LinkState.DOWN if f"gpu{g}/nvlink{k}" in n_down else LinkState.UP,
                           crc_errors=crc)
            for g in range(chips) for k in range(per_chip)]


def _ref_links(links):
    return [ICILinkSnapshot(chip_id=ln.gpu_id, link_id=ln.link_id, state=ln.state,
                            tx_bytes=ln.tx_bytes, rx_bytes=ln.rx_bytes, tx_errors=ln.tx_errors,
                            rx_errors=ln.rx_errors, crc_errors=ln.crc_errors, replays=ln.replays)
            for ln in links]


class Stores:
    """The port's store over one DB and the reference's over another, both
    written the same, plus the reference's store over the port's DB."""

    def __init__(self, tmp_path, now=1000.0, **kw):
        self.port_db = DB(str(tmp_path / "port.db"))
        self.ref_db = RefDB(str(tmp_path / "ref.db"))
        self.port = NVLinkStore(self.port_db, **kw)
        self.ref = ICIStore(self.ref_db, **kw)
        self.ref_on_port = ICIStore(RefDB(str(tmp_path / "port.db")), **kw)
        self.now = [now]
        for s in (self.port, self.ref, self.ref_on_port):
            s.time_now_fn = lambda: self.now[0]
        self.ref.native_enabled = self.ref_on_port.native_enabled = False

    def insert(self, links, ts):
        self.port.insert_snapshot(links, ts=ts)
        self.ref.insert_snapshot(_ref_links(links), ts=ts)

    def tombstone(self, link, ts):
        self.port.set_tombstone(link, ts=ts)
        self.ref.set_tombstone(link if link == "*" else _ref_name(link), ts=ts)

    def scan(self, window):
        """The port's scan, held to the reference's over both DBs."""
        got = self.port.scan(window)
        for ref in (self.ref.scan(window), self.ref_on_port.scan(window)):
            assert ref.window_start == got.window_start
            want = {link_name(k): {**v.__dict__, "link": link_name(v.link)}
                    for k, v in ref.links.items()}
            assert {k: v.__dict__ for k, v in got.links.items()} == want
        return got

    def close(self):
        for db in (self.port_db, self.ref_db, self.ref_on_port.db):
            db.close()


def _ref_name(port_name):
    g, k = port_name.replace("gpu", "").split("/nvlink")
    return f"chip{g}/ici{k}"


@pytest.fixture
def stores(tmp_path):
    s = Stores(tmp_path)
    yield s
    s.close()


# -- tests/test_ici.py, store level -------------------------------------------

def test_store_scan_detects_drop_and_flap(stores):
    stores.insert(_links(), ts=900.0)
    stores.insert(_links(n_down=["gpu0/nvlink1"]), ts=920.0)
    stores.insert(_links(), ts=940.0)
    stores.insert(_links(n_down=["gpu1/nvlink3"]), ts=960.0)
    res = stores.scan(200.0)
    assert (res.links["gpu0/nvlink1"].drops, res.links["gpu0/nvlink1"].flaps) == (1, 1)
    assert not res.links["gpu0/nvlink1"].currently_down
    assert res.down_links == ["gpu1/nvlink3"]
    assert "gpu0/nvlink1" in res.dropped_links and res.flapping_links == ["gpu0/nvlink1"]


def test_store_tombstone_masks_history(stores):
    stores.insert(_links(n_down=["gpu0/nvlink0"]), ts=910.0)
    stores.insert(_links(), ts=930.0)
    stores.tombstone("*", ts=950.0)
    stores.insert(_links(), ts=960.0)
    res = stores.scan(200.0)
    assert (res.links["gpu0/nvlink0"].drops, res.links["gpu0/nvlink0"].flaps) == (0, 0)


def test_store_per_link_tombstone(stores):
    stores.insert(_links(n_down=["gpu0/nvlink0", "gpu1/nvlink2"]), ts=910.0)
    stores.tombstone("gpu0/nvlink0", ts=950.0)
    res = stores.scan(200.0)
    assert "gpu0/nvlink0" not in res.links and res.links["gpu1/nvlink2"].currently_down
    assert stores.port.tombstone_for("gpu0/nvlink0") == 950.0


def test_store_counter_deltas(stores):
    stores.insert(_links(crc=10), ts=900.0)
    stores.insert(_links(crc=250), ts=950.0)
    assert stores.scan(200.0).links["gpu0/nvlink0"].crc_delta == 240


def test_store_purge(tmp_path):
    s = Stores(tmp_path, retention_seconds=100)
    s.insert(_links(), ts=800.0)
    s.insert(_links(), ts=950.0)
    assert s.port.purge() == s.ref.purge() == 8
    assert sorted(s.port.link_names()) == sorted(map(link_name, s.ref.link_names()))
    assert len(s.port.link_names()) == 8
    s.close()


def test_schema_is_the_reference_schema(stores):
    assert (TABLE, TOMBSTONE_TABLE) == (REF_TABLE, REF_TOMBSTONES) == (
        torch_fs.TABLE, torch_fs.TOMBSTONE_TABLE)
    q = "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name"
    assert stores.port_db.query(q) == stores.ref_db.query(q)


def test_nvml_counters_land_in_the_reference_columns(stores):
    ln = NVLinkSnapshot(gpu_id=3, link_id=17, state=LinkState.UP, tx_errors=2, rx_errors=7,
                        crc_errors=15, replays=3)
    stores.insert([ln], ts=990.0)
    row = stores.port_db.query(f"SELECT link, state, tx_errors, rx_errors, crc_errors, "
                               f"replays FROM {TABLE}")
    assert [tuple(r) for r in row] == [("gpu3/nvlink17", 1, 2, 7, 15, 3)]


# -- seeded histories: the scan, and fleet_scan in both packages ---------------------

def _random_history(rng, stores, steps, chips=2, per_chip=3, t0=NOW - 7200.0):
    """One-minute snapshots with random drops, recoveries, CRC steps and
    counter resets; sometimes a tombstone."""
    names = [f"gpu{g}/nvlink{k}" for g in range(chips) for k in range(per_chip)]
    crc = {n: int(rng.integers(0, 1000)) for n in names}
    down = set()
    for step in range(steps):
        for n in names:
            u = rng.random()
            if u < 0.08:
                down.symmetric_difference_update({n})
            crc[n] = 0 if rng.random() < 0.03 else crc[n] + int(rng.integers(0, 40))
        links = [NVLinkSnapshot(gpu_id=int(n[3]), link_id=int(n.split("nvlink")[1]),
                                state=LinkState.DOWN if n in down else LinkState.UP,
                                crc_errors=crc[n], tx_errors=int(rng.integers(0, 3)))
                 for n in names]
        stores.insert(links, ts=t0 + 60.0 * step)
        if rng.random() < 0.02:
            stores.tombstone("*" if rng.random() < 0.5 else rng.choice(names),
                             ts=t0 + 60.0 * step + 30.0)
    return names


@pytest.mark.parametrize("seed", range(10))
def test_seeded_history_scan_matches_the_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    s = Stores(tmp_path, now=NOW)
    _random_history(rng, s, steps=int(rng.integers(20, 120)))
    for window in (600.0, 3600.0, 7200.0):
        s.scan(window)
    s.close()


@pytest.mark.parametrize("seed", range(6))
def test_port_rows_classified_alike_by_both_fleet_scans(tmp_path, seed):
    rng = np.random.default_rng(100 + seed)
    paths = []
    for h in range(3):
        sub = tmp_path / f"h{h}"
        sub.mkdir()
        s = Stores(sub, now=NOW)
        _random_history(rng, s, steps=90)
        s.close()
        paths.append(str(sub / "port.db"))
    kw = dict(window_seconds=3600.0, now=NOW)
    ref = jax_fs.fleet_scan(paths, **kw)
    got = torch_fs.fleet_scan(paths, device="cpu", **kw)
    assert got["links"] == ref["links"] and got["summary"] == ref["summary"]
    assert got["truncated_links"] == ref["truncated_links"]
    assert len(got["links"]) == 3 * 6


def test_fleet_scan_reads_a_drop_and_a_flap_the_store_wrote(tmp_path):
    """The adapter phase's sequence: six samples, one link down in 3-4."""
    db = DB(str(tmp_path / "host.db"))
    store = NVLinkStore(db)
    store.time_now_fn = lambda: NOW
    for k in range(1, 7):
        store.insert_snapshot(_links(n_down=["gpu0/nvlink0"] if k in (3, 4) else ()),
                              ts=NOW - 60.0 * (6 - k))
    scan = store.scan(3600.0)
    db.close()
    assert (scan.links["gpu0/nvlink0"].drops, scan.links["gpu0/nvlink0"].flaps) == (1, 1)
    paths = [str(tmp_path / "host.db")]
    got = torch_fs.fleet_scan(paths, window_seconds=3600.0, now=NOW, device="cpu")
    assert got["links"] == jax_fs.fleet_scan(paths, window_seconds=3600.0, now=NOW)["links"]
    assert got["links"]["host/gpu0/nvlink0"] == "degraded"
    assert got["summary"] == {"healthy": 7, "degraded": 1, "unhealthy": 0}


def test_port_link_conversion_round_trips():
    ln = NVLinkSnapshot(gpu_id=1, link_id=2, crc_errors=5)
    assert port_link(_ref_links([ln])[0]) == ln
