"""The port's fabric plane (gpud_tpu_torch/fabric/): what a link is on a GPU
host, and the sweep's state machine held against gpud_tpu's.

A link here is one GPU's NVLink port, GPU to switch (fabric/mesh.py), where
the reference sweeps a 2-D torus of TPU chips; the reference's torus tests
(tests/test_fabric.py's mesh cases) are replaced by tests of that star: the
mock's 8 GPUs x 18 ports give 144 links named ``gpu{g}/nvlink{k}``, a down
port downs exactly its link, and a link's neighbours are the other 17 ports
of its GPU.

The state machine is not a design choice, so it is held against the
reference's plane: both planes get the same number of links, in the same
order, the same up/down per link through ``links_fn`` and the same probe
series through ``telemetry_fn``; then, sweep by sweep, each link's state,
latency and deviation (links matched by position), the publish set, the
store's rows and ``deviation_scores()`` must be equal. The EWMA and z-score
arithmetic is the same in both, so floats are compared with ``==``.
``neighbor_cooccurrence`` is held on the same inputs in both packages; the
plane's ``cooccurrence_score()`` differs only by the adjacency it builds,
which is tested on its own. The store, the metric cap and the config knobs
follow the reference's cases (tests/test_fabric.py:106-272)."""

import dataclasses

import numpy as np
import pytest

from gpud_tpu.config import default_config as ref_default_config
from gpud_tpu.metrics.registry import DEFAULT_REGISTRY as REF_REGISTRY
from gpud_tpu.tpu.instance import ICILinkSnapshot
from gpud_tpu.tpu.instance import LinkState as RefLinkState

from gpud_tpu_torch.components.gpu.nvlink import NAME as NVLINK_NAME
from gpud_tpu_torch.config import default_config
from gpud_tpu_torch.fabric.mesh import (
    SOURCE_DEGRADED,
    SOURCE_NVML,
    SWITCH_SIDE,
    MeshLink,
    discover_mesh,
    link_port_state,
    mesh_links,
)
from gpud_tpu_torch.fabric.plane import STATE_DEGRADED, STATE_DOWN, STATE_UP, FabricPlane
from gpud_tpu_torch.gpu.instance import LinkState, MockBackend, NVLinkSnapshot
from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY as PORT_REGISTRY
from gpud_tpu_torch.sqlite import DB

from torch_plane_parity import IDS, PKGS, PORT, REF, Clock, both

BASE = 1e-4  # the reference's synthetic probe


@pytest.fixture()
def db(tmp_path):
    d = DB(str(tmp_path / "fabric.db"))
    yield d
    d.close()


# -- the star: one link per NVLink port ---------------------------------------


def test_the_mock_gives_144_links_named_as_the_nvlink_snapshots():
    gpu = MockBackend()
    mesh = discover_mesh(gpu)
    links = mesh_links(mesh)
    assert mesh.source == SOURCE_NVML and mesh.shape == (8, 18)
    assert mesh.chips == tuple(range(8))
    assert len(links) == 144
    assert [ln.name for ln in links] == [s.name for s in gpu.nvlink_links()]
    assert links[0].to_dict() == {"link": "gpu0/nvlink0", "src_chip": 0,
                                  "dst_chip": SWITCH_SIDE, "axis": "nvlink"}
    assert (links[-1].src_chip, links[-1].port, links[-1].name) == (7, 17, "gpu7/nvlink17")
    assert mesh.to_dict() == {"shape": [8, 18], "chips": 8, "source": "nvml"}


class Inventory:
    """An adapter whose NVLink walk gives the listed (gpu, port) pairs."""

    def __init__(self, ports, down=()):
        self.ports, self.down = list(ports), set(down)

    def nvlink_links(self):
        return [NVLinkSnapshot(gpu_id=g, link_id=k,
                               state=LinkState.DOWN if (g, k) in self.down else LinkState.UP)
                for g, k in self.ports]


class Broken:
    def nvlink_links(self):
        raise RuntimeError("NVML gone")


@pytest.mark.parametrize("gpu", [None, Inventory([]), Broken()], ids=["none", "empty", "raises"])
def test_no_inventory_degrades_to_no_links(gpu):
    mesh = discover_mesh(gpu)
    assert (mesh.shape, mesh.source, mesh_links(mesh)) == ((1, 1), SOURCE_DEGRADED, [])


def test_one_gpu_is_a_fabric_of_its_own_ports():
    # the card's machine: one visible H100, 18 active ports; the
    # reference's torus would give a degraded 1x1 mesh with no links there
    mesh = discover_mesh(Inventory([(0, k) for k in range(18)]))
    assert mesh.shape == (1, 18) and mesh.source == SOURCE_NVML
    assert len(mesh_links(mesh)) == 18


def test_uneven_inventories_keep_every_listed_port_in_order():
    mesh = discover_mesh(Inventory([(3, 1), (1, 4), (1, 0), (3, 0), (3, 2)]))
    assert mesh.shape == (2, 3) and mesh.chips == (1, 3)
    assert [ln.name for ln in mesh_links(mesh)] == [
        "gpu1/nvlink0", "gpu1/nvlink4", "gpu3/nvlink0", "gpu3/nvlink1", "gpu3/nvlink2"]


def test_the_fold_reads_the_link_s_one_port():
    link = MeshLink(src_chip=2, port=5)
    assert link_port_state(link, {}) is None
    assert link_port_state(link, {(2, 5): True, (2, 4): False}) is True
    assert link_port_state(link, {(2, 5): False}) is False
    assert link_port_state(link, {(5, 2): False}) is None


def test_a_down_port_downs_exactly_its_link(db):
    gpu = MockBackend()
    p = FabricPlane(db, gpu=gpu, warmup_sweeps=1, time_now_fn=Clock())
    try:
        p.sweep_once()
        p.links_fn = lambda: [dataclasses.replace(s, state=LinkState.DOWN)
                              if s.name == "gpu5/nvlink11" else s for s in gpu.nvlink_links()]
        p.sweep_once()
        states = {r["link"]: r["state"] for r in p.matrix()}
        assert states.pop("gpu5/nvlink11") == STATE_DOWN
        assert set(states.values()) == {STATE_UP} and len(states) == 143
        assert p.status()["down"] == ["gpu5/nvlink11"]
    finally:
        p.close()


def test_the_mock_s_injected_down_link_is_down_in_the_sweep(db, monkeypatch):
    monkeypatch.setenv("TPUD_GPU_INJECT_NVLINK_LINK_DOWN", "gpu3/nvlink7")
    p = FabricPlane(db, gpu=MockBackend(), time_now_fn=Clock())
    try:
        assert p.sweep_once()["published"] == 1
        assert p.status()["down"] == ["gpu3/nvlink7"]
    finally:
        p.close()


def test_a_link_s_neighbours_are_the_other_ports_of_its_gpu(db):
    p = FabricPlane(db, gpu=MockBackend(), time_now_fn=Clock())
    try:
        p.sweep_once()
        adj = p._adjacency
        assert len(adj) == 144
        assert adj["gpu2/nvlink0"] == sorted(f"gpu2/nvlink{k}" for k in range(1, 18))
        assert all(len(peers) == 17 and all(q.split("/")[0] == name.split("/")[0] for q in peers)
                   for name, peers in adj.items())
    finally:
        p.close()


def test_co_occurrence_needs_two_hot_ports_of_one_gpu(db):
    p = FabricPlane(db, gpu=MockBackend(), warmup_sweeps=2, time_now_fn=Clock())
    try:
        for _ in range(4):
            p.sweep_once()
        hot = {"gpu0/nvlink0"}
        p.telemetry_fn = lambda ln: 100 * BASE if ln.name in hot else BASE
        p.sweep_once()
        assert p.cooccurrence_score() == 0.0
        hot = {"gpu0/nvlink0", "gpu1/nvlink0"}  # two GPUs: not neighbours
        p.sweep_once()
        assert p.cooccurrence_score() == 0.0
        hot = {"gpu0/nvlink0", "gpu0/nvlink9"}  # one GPU's two ports
        p.sweep_once()
        assert p.cooccurrence_score() > 0.4
        assert p.cooccurrence_score() == PORT.features.neighbor_cooccurrence(
            p.deviation_scores(), p._adjacency)
    finally:
        p.close()


def test_the_plane_feeds_the_nvlink_check_s_score():
    assert FabricPlane.component_name == NVLINK_NAME == "accelerator-gpu-nvlink"
    assert REF.plane.FabricPlane.component_name == "accelerator-tpu-ici"


# -- the state machine against the reference's plane -------------------------


class RefTorus:
    """The reference's adapter for its plane: ``chips`` chips with six ICI
    ports each, all up."""

    def __init__(self, chips):
        self.chips = chips

    def ici_links(self):
        return [ICILinkSnapshot(chip_id=c, link_id=k, state=RefLinkState.UP)
                for c in range(self.chips) for k in range(6)]


# reference chips -> the port's (GPUs, ports) with as many links
SIZES = {"12": (8, (2, 6)), "32": (16, (4, 8))}


def adapter(P, size):
    chips, (gpus, ports) = SIZES[size]
    if P is REF:
        return RefTorus(chips)
    return Inventory([(g, k) for g in range(gpus) for k in range(ports)])


def links_of(P, gpu):
    return P.mesh.mesh_links(P.mesh.discover_mesh(gpu))


def port_of(P, link):
    """The (device, port) whose state decides ``link``."""
    if P is REF:
        return P.mesh.link_ports(link)[0]
    return (link.src_chip, link.port)


def snapshots(P, gpu, down_ports):
    if P is REF:
        return [dataclasses.replace(s, state=RefLinkState.DOWN)
                if (s.chip_id, s.link_id) in down_ports else s for s in gpu.ici_links()]
    return [dataclasses.replace(s, state=LinkState.DOWN)
            if (s.gpu_id, s.link_id) in down_ports else s for s in gpu.nvlink_links()]


def run(P, tmp, size, sweeps, **knobs):
    """Drive one plane over ``sweeps``: per sweep, (down positions, a probe
    of (position, sweep) -> latency or an exception, clock step). Returns
    every observation with links named by their position."""
    gpu = adapter(P, size)
    links = links_of(P, gpu)
    pos = {ln.name: i for i, ln in enumerate(links)}
    db = P.sqlite.DB(str(tmp / f"{P.name}-{size}.db"))
    clock = Clock()
    kw = {"tpu" if P is REF else "gpu": gpu}
    plane = P.plane.FabricPlane(db, time_now_fn=clock, **kw, **knobs)
    published = []
    plane.on_publish = published.append

    def anon(row):
        return {k: (pos[v] if k == "link" else v) for k, v in row.items()
                if k not in ("src_chip", "dst_chip", "axis")}

    seen = []
    try:
        for n, (down, probe, step) in enumerate(sweeps):
            clock.advance(step)
            down_ports = {port_of(P, links[i]) for i in down}
            plane.links_fn = lambda: snapshots(P, gpu, down_ports)

            def telemetry(link, n=n, probe=probe):
                v = probe(pos[link.name], n)
                if isinstance(v, Exception):
                    raise v
                return v

            plane.telemetry_fn = telemetry
            before = len(published)
            result = plane.sweep_once()
            st = plane.status()
            seen.append({
                "result": result,
                "matrix": sorted((anon(r) for r in plane.matrix()), key=lambda r: r["link"]),
                "published": [anon(b) for b in published[before:]],
                "scores": sorted((pos[k], v) for k, v in plane.deviation_scores().items()),
                "status": {k: (sorted(pos[x] for x in v) if k in ("degraded", "down") else v)
                           for k, v in st.items() if k not in ("mesh", "last_sweep_seconds")},
            })
        store = sorted((r["ts"], pos[r["link"]], r["state"], r["latency_seconds"], r["deviation"])
                       for r in plane.history(limit=10_000))
        assert plane.store.row_count() == len(sweeps) * len(links)
        purged = plane.purge_once()
        return {"sweeps": seen, "store": store, "purged": purged, "links": len(links)}
    finally:
        plane.close()
        db.close()


def const(v=BASE):
    return lambda i, n: v


def series(seed, hot=(), ramp=0.0, spread=0.02):
    """A seeded probe series: every link near BASE, the ``hot`` ones
    climbing by ``ramp`` x BASE per sweep."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, spread, size=(64, 40))
    return lambda i, n: float(BASE * (1.0 + noise[i, n] + (ramp * n if i in hot else 0.0)))


SCENARIOS = {
    "baseline": [(set(), const(), 1.0)] * 4,
    "one_link_deviates_and_stays_flagged":
        [(set(), const(), 1.0)] * 4
        + [(set(), lambda i, n: 100 * BASE if i == 0 else BASE, 1.0)] * 4
        + [(set(), const(), 1.0)] * 2,
    "a_port_down_then_recovery":
        [(set(), const(), 1.0)] * 3 + [({5}, const(), 1.0)] + [(set(), const(), 1.0)] * 2,
    "two_down_and_one_deviating":
        [(set(), const(), 1.0)] * 3
        + [({1, 7}, lambda i, n: 50 * BASE if i == 3 else BASE, 2.0)] * 2
        + [({7}, const(), 2.0), (set(), const(), 2.0)],
    "a_seeded_noisy_series_with_ramps":
        [(set(), series(7, hot={2, 9}, ramp=0.6), 1.0)] * 14,
    "a_failing_probe_reads_zero":
        [(set(), const(), 1.0)] * 3
        + [(set(), lambda i, n: RuntimeError("probe") if i == 4 else BASE, 1.0)] * 2,
    "down_before_any_baseline":
        [({0, 2}, const(), 1.0)] * 2 + [(set(), const(), 1.0)] * 4,
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_the_sweep_is_the_reference_s(scenario, size, tmp_path):
    ref, port = both(run, tmp_path, size, SCENARIOS[scenario], warmup_sweeps=2,
                     latency_threshold_z=4.0)
    assert port["links"] == ref["links"] == {"12": 12, "32": 32}[size]
    assert port == ref


@pytest.mark.parametrize("knobs", [
    dict(warmup_sweeps=0), dict(ewma_alpha=0.5, latency_threshold_z=2.0),
    dict(warmup_sweeps=5, latency_threshold_z=1.0), dict(retention_seconds=3.0),
], ids=["no_warmup", "fast_alpha", "long_warmup_low_z", "short_retention"])
def test_the_sweep_under_other_knobs_is_the_reference_s(knobs, tmp_path):
    ref, port = both(run, tmp_path, "12", SCENARIOS["a_seeded_noisy_series_with_ramps"], **knobs)
    assert port == ref


def test_the_reference_s_plane_cases_hold_on_the_port(tmp_path):
    # tests/test_fabric.py's sweep cases, by position on both planes
    ref, port = both(run, tmp_path, "12", SCENARIOS["one_link_deviates_and_stays_flagged"],
                     warmup_sweeps=2, latency_threshold_z=4.0)
    for got in (ref, port):
        s = got["sweeps"]
        assert all(r["state"] == STATE_UP for r in s[3]["matrix"]) and s[3]["published"] == []
        assert [r["state"] for r in s[4]["matrix"]].count(STATE_DEGRADED) == 1
        assert s[7]["status"]["degraded"] == [0]
        assert {p["link"] for x in s[4:8] for p in x["published"]} == {0}
        assert dict(s[7]["scores"])[0] > 0.5 and dict(s[7]["scores"])[1] == 0.0
    assert port == ref


@pytest.mark.parametrize("case", ["empty", "one_hot", "a_pair", "hostile", "three_chain"])
def test_neighbor_cooccurrence_is_the_reference_s(case):
    adj = {"a": ["b"], "b": ["a", "c"], "c": ["b"]}
    dev = {"empty": {}, "one_hot": {"a": 0.9, "b": 0.0, "c": 0.0},
           "a_pair": {"a": 0.9, "b": 0.7, "c": 0.0}, "hostile": {"a": 5.0, "b": 7.0},
           "three_chain": {"a": 0.3, "b": 0.8, "c": 0.6}}[case]
    ref, port = both(lambda P: P.features.neighbor_cooccurrence(dev, adj))
    assert port == ref
    assert port == {"empty": 0.0, "one_hot": 0.0, "a_pair": 0.7, "hostile": 1.0,
                    "three_chain": 0.6}[case]


# -- durable matrix store ---------------------------------------------------


def store_roundtrip(P, tmp):
    db = P.sqlite.DB(str(tmp / f"{P.name}.db"))
    try:
        st = P.fabric_store.FabricMatrixStore(db)
        rows = [
            {"link": "gpu0/nvlink1", "src_chip": 0, "dst_chip": -1, "axis": "nvlink",
             "state": "up", "latency_seconds": 1e-4, "deviation": 0.0},
            {"link": "gpu1/nvlink2", "src_chip": 1, "dst_chip": -1, "axis": "nvlink",
             "state": "degraded", "latency_seconds": 2e-3, "deviation": 9.0},
            {"link": "gpu1/nvlink3"},
        ]
        assert st.insert_sweep([]) == 0
        st.insert_sweep(rows, ts=100.0)
        st.insert_sweep(rows, ts=200.0)
        assert st.row_count() == 6
        hist = st.history(link="gpu1/nvlink2")
        assert [h["ts"] for h in hist] == [200.0, 100.0] and hist[0]["state"] == "degraded"
        assert st.history(since=150.0, limit=1)[0]["ts"] == 200.0
        out = (hist, st.history(), st.history(limit=0), st.history(since=150.0, limit=10**9))
        assert st.purge(before=150.0) == 3 and st.row_count() == 3
        return out, db.query("SELECT name, sql FROM sqlite_master ORDER BY name")
    finally:
        db.close()


def test_the_store_is_the_reference_s(tmp_path):
    ref, port = both(store_roundtrip, tmp_path)
    assert port == ref
    assert {name for name, _ in port[1]} == {
        "tpud_fabric_matrix_v0_1", "idx_fabric_link_ts", "idx_fabric_ts"}


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_the_store_writes_through_the_shared_writer(P, tmp_path):
    db = P.sqlite.DB(str(tmp_path / "w.db"))
    w = P.storage.BatchWriter(db)
    try:
        st = P.fabric_store.FabricMatrixStore(db, writer=w)
        st.insert_sweep([{"link": "l", "state": "up"}], ts=5.0)
        assert w.stats()["pending_ops"] == 1
        assert st.row_count() == 1  # the read is a barrier
    finally:
        w.close()
        db.close()


# -- metric cap and config ----------------------------------------------------


def truncated(registry):
    for m in registry.all_metrics():
        if m.name == "tpud_fabric_metric_links_truncated":
            return [v for _, v in m.labels_values()]
    return None


def test_the_metric_cap_counts_truncation_as_the_reference(tmp_path):
    def scenario(P):
        db = P.sqlite.DB(str(tmp_path / f"{P.name}-cap.db"))
        p = P.plane.FabricPlane(db, **{"tpu" if P is REF else "gpu": adapter(P, "12")},
                                metric_links_max=5)
        try:
            p.sweep_once()
            return truncated(REF_REGISTRY if P is REF else PORT_REGISTRY)
        finally:
            p.close()
            db.close()
    ref, port = both(scenario)
    assert port == ref == [7.0]
    assert PORT.plane.DEFAULT_METRIC_LINKS_MAX == REF.plane.DEFAULT_METRIC_LINKS_MAX == 64


def test_the_default_cap_truncates_an_8_gpu_host(db):
    p = FabricPlane(db, gpu=MockBackend())
    try:
        p.sweep_once()
        assert truncated(PORT_REGISTRY) == [80.0]  # 144 links - 64 exported
    finally:
        p.close()


@pytest.mark.parametrize("knob, bad", [
    ("fabric_sweep_interval_seconds", 0), ("fabric_sweep_latency_threshold_z", -1.0),
    ("fabric_sweep_ewma_alpha", 1.5), ("fabric_sweep_warmup_sweeps", 0),
    ("fabric_sweep_retention_seconds", 10)])
def test_the_fabric_knobs_validate_as_the_reference(tmp_path, knob, bad):
    got = []
    for make in (ref_default_config, default_config):
        c = make(data_dir=str(tmp_path))
        assert c.validate() is None
        setattr(c, knob, bad)
        got.append(c.validate())
    assert got[0] == got[1] and "fabric" in got[1]


# -- the manager's fabric pane (tests/test_fabric.py:299-366) -----------------
#
# The reference's rollup cases run on both packages' FleetRollupStore, once
# with the reference's torus records and once with the port's: an NVLink
# port's record is ``MeshLink.to_dict()`` (GPU to switch, ``dst_chip`` -1,
# axis ``nvlink``), with the plane's state, latency, deviation and ts.


def torus_rec(seq, ts, link, state, agent_suffix=""):
    body = {"link": link, "src_chip": 0, "dst_chip": 1, "axis": "x",
            "state": state, "latency_seconds": 2e-3, "deviation": 5.0, "ts": ts}
    return (seq, ts, "ici_link", f"ici_link:{agent_suffix}{link}:{ts}", body)


def nvlink_rec(seq, ts, link, state, agent_suffix=""):
    # the torus names map onto ports of GPUs 0 and 1
    gpu, port = {"c0-c1/x": (0, 3), "c2-c3/x": (1, 17)}.get(link, (0, 0))
    body = {**MeshLink(gpu, port).to_dict(), "state": state, "latency_seconds": 2e-3,
            "deviation": 5.0, "ts": ts}
    name = body["link"]
    return (seq, ts, "ici_link", f"ici_link:{agent_suffix}{name}:{ts}", body)


RECORD_SHAPES = {"torus": torus_rec, "nvlink": nvlink_rec}


def rollup_answers_since(P, tmp, rec):
    db = P.sqlite.DB(str(tmp / f"{P.name}-since.db"))
    st = P.rollup.FleetRollupStore(db, None)
    st.ingest("agent-a", [rec(1, 100.0, "c0-c1/x", STATE_DEGRADED),
                          rec(2, 110.0, "c0-c1/x", STATE_UP),       # recovered
                          rec(3, 120.0, "c2-c3/x", STATE_DOWN)])   # still down
    st.ingest("agent-b", [rec(1, 130.0, "c0-c1/x", STATE_DOWN)])
    pane = st.fleet_fabric(since=0.0, now=200.0)
    assert pane["agents"] == 2 and pane["links_total"] == 3
    assert len(pane["degraded"]) == 3
    assert pane["degraded"][0]["state"] == STATE_DOWN
    later = st.fleet_fabric(since=115.0, now=200.0)
    assert len(later["degraded"]) == 2
    snap = st.agent_snapshot("agent-a")
    assert snap["records_by_kind"]["ici_link"] == 3
    out = (pane, later, snap)
    db.close()
    return out


def rollup_dedupes_redelivery(P, tmp, rec):
    db = P.sqlite.DB(str(tmp / f"{P.name}-dedupe.db"))
    st = P.rollup.FleetRollupStore(db, None)
    r = rec(1, 100.0, "c0-c1/x", STATE_DOWN)
    fresh = [st.ingest("agent-a", [r]), st.ingest("agent-a", [r])]  # redelivery
    assert st.records_total() == 1
    pane = st.fleet_fabric(now=200.0)
    assert pane["degraded"][0]["records"] == 1
    db.close()
    return fresh, pane


def rollup_survives_replay(P, tmp, rec):
    db = P.sqlite.DB(str(tmp / f"{P.name}-replay.db"))
    st = P.rollup.FleetRollupStore(db, None)
    st.ingest("agent-a", [rec(1, 100.0, "c0-c1/x", STATE_DOWN)])
    before = st.fleet_fabric(now=200.0)
    after = P.rollup.FleetRollupStore(db, None).fleet_fabric(now=200.0)
    # equal but for the store-local generation counter
    before.pop("generation")
    after.pop("generation")
    assert after == before
    db.close()
    return after


def rollup_ignores_empty_link(P, tmp, rec):
    db = P.sqlite.DB(str(tmp / f"{P.name}-empty.db"))
    st = P.rollup.FleetRollupStore(db, None)
    st.ingest("agent-a", [(1, 100.0, "ici_link", "ici_link::100", {"link": "", "state": "down"})])
    assert st.fleet_fabric()["links_total"] == 0
    assert P.rollup.MAX_LINKS_PER_AGENT >= 1024
    out = st.fleet_fabric(now=200.0), st.agent_snapshot("agent-a")
    db.close()
    return out


ROLLUP_CASES = {
    "answers_since": rollup_answers_since,
    "dedupes_redelivery": rollup_dedupes_redelivery,
    "survives_journal_replay": rollup_survives_replay,
    "ignores_empty_link": rollup_ignores_empty_link,
}


@pytest.mark.parametrize("shape", RECORD_SHAPES)
@pytest.mark.parametrize("case", ROLLUP_CASES)
def test_the_fleet_fabric_pane_is_the_reference_s(case, shape, tmp_path):
    ref, port = both(ROLLUP_CASES[case], tmp_path, RECORD_SHAPES[shape])
    assert port == ref


def fold_src_chip(P, tmp):
    """A reference quirk the port keeps (ROADMAP §C):
    ``_LinkRollup.apply`` reads ``int(body.get("src_chip", ...) or -1)``,
    so a link of GPU 0 (or TPU chip 0) is reported with ``src_chip`` -1."""
    db = P.sqlite.DB(str(tmp / f"{P.name}-fold.db"))
    st = P.rollup.FleetRollupStore(db, None)
    recs = []
    for seq, gpu in enumerate((0, 1, 7), start=1):
        body = {**MeshLink(gpu, 5).to_dict(), "state": STATE_DOWN, "ts": 100.0 + seq}
        recs.append((seq, 100.0 + seq, "ici_link", f"ici_link:{body['link']}", body))
    st.ingest("h100-host", recs)
    pane = st.fleet_fabric(now=200.0)
    db.close()
    return {d["link"]: (d["src_chip"], d["dst_chip"], d["axis"]) for d in pane["degraded"]}


def test_gpu_0_folds_to_minus_1_in_the_fleet_pane_as_in_the_reference(tmp_path):
    ref, port = both(fold_src_chip, tmp_path)
    assert port == ref == {
        "gpu0/nvlink5": (-1, -1, "nvlink"),
        "gpu1/nvlink5": (1, -1, "nvlink"),
        "gpu7/nvlink5": (7, -1, "nvlink"),
    }
