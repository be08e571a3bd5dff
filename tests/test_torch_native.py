"""The port's native host library (gpud_tpu_torch/native.py over
native/tpud_native.cpp) against its Python twins and gpud_tpu's.

The library is built here by ``native.build()`` with g++ into a temp dir and
loaded through ``TPUD_NATIVE_LIB``; the cases skip, with that reason, only on
a host without g++. Each native path is held to the Python one it replaces:
the kmsg parser on the Xid/SXid corpus (tests/torch_xid_corpus.py) and the
lines of other devices, the TTL deduper in lockstep, the catalog prefilter
against its regex, and NVLinkStore's ragged scan against its Python walk and
the reference's ICIStore. The cases of the reference's tests/test_native.py
and test_kmsg_parse_fallback.py."""

import dataclasses
import shutil

import numpy as np
import pytest

import gpud_tpu.kmsg.watcher as ref_watcher
from gpud_tpu.components.tpu.ici_store import ICIStore
from gpud_tpu.kmsg.deduper import Deduper as RefDeduper
from gpud_tpu.sqlite import DB as RefDB
from gpud_tpu.tpu.instance import ICILinkSnapshot

import gpud_tpu_torch.kmsg.watcher as watcher
from gpud_tpu_torch import native
from gpud_tpu_torch.components.gpu import catalog
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore
from gpud_tpu_torch.gpu.instance import NVLinkSnapshot
from gpud_tpu_torch.kmsg import deduper as deduper_mod
from gpud_tpu_torch.kmsg.syncer import Syncer
from gpud_tpu_torch.sqlite import DB

import torch_xid_corpus as corpus
from torch_parity import link_name

BOOT = 1_700_000_000.0
CORPUS = [ln for lines in corpus.ORGANIC.values() for ln in lines] + list(corpus.BENIGN)
# kmsg records around the corpus, then the parser's edge cases
RECORDS = [f"{(i % 8) + 8 * (i % 3)},{1000 + i},{5_000_000 + 17 * i},-;{ln}"
           for i, ln in enumerate(CORPUS)] + [
    "6,1234,5678901,-;hello world", "26,1,10,-;msg;with;semis", "3,99,0,c;x",
    "3,9,12,extra,fields;NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus.\n",
    "7,3,40,-;", " SUBSYSTEM=pci", "no-separator", "a,b,c;x", "", "6,1;x", "6,,1,-;x",
    "-6,2,3,-;negative prefix", "6,2,3;no flags", "6,2,3,-;ünïcödé",
]
# past 2^63 - 1: the native parser clamps (strtoll), the Python one does not
OVERFLOW = ["6,99999999999999999999,1,-;big seq", "6,1,99999999999999999999,-;big ts"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native library cannot be built")
    return native.build(tmp_path_factory.mktemp("native"))


@pytest.fixture()
def lib(built, monkeypatch):
    """The freshly built library, loaded through TPUD_NATIVE_LIB; the
    loader's state goes back as it was after the case."""
    monkeypatch.setenv("TPUD_NATIVE_LIB", str(built))
    for name, value in (("_LIB", None), ("_TRIED", False), ("_PATH", ""),
                        ("_PREFILTER_READY", False)):
        monkeypatch.setattr(native, name, value)
    assert native.available() and native.loaded_path() == str(built)
    return native


def _fields(m):
    return None if m is None else dataclasses.astuple(m)


# -- build and load ----------------------------------------------------------------

def test_build_compiles_the_reference_source_into_the_given_dir(built):
    assert built.name == "libtpud_native.so" and built.is_file()
    assert native.SOURCE.name == "tpud_native.cpp" and native.SOURCE.parent.name == "native"
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.CXXFLAGS == ("-O2", "-fPIC", "-std=c++17", "-shared")
    assert not list(built.parent.glob(".*.tmp"))


def test_build_without_gxx_raises_with_a_reason(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(tmp_path)


def test_a_failed_compile_raises_and_leaves_nothing(built, monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken(")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(tmp_path / "out")
    assert list((tmp_path / "out").iterdir()) == []


def test_the_search_order_never_names_the_reference_s_library(monkeypatch):
    monkeypatch.setenv("TPUD_NATIVE_LIB", "custom/libtpud_native.so")
    assert native._candidates() == ["custom/libtpud_native.so",
                                    str(native.BUILD_DIR / "libtpud_native.so"),
                                    "libtpud_native.so"]
    monkeypatch.delenv("TPUD_NATIVE_LIB")
    assert not any("native/libtpud_native.so" in c.replace("build/native", "")
                   for c in native._candidates())


def test_without_a_library_the_python_twins_run(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUD_NATIVE_LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    for name, value in (("_LIB", None), ("_TRIED", False), ("_PATH", "")):
        monkeypatch.setattr(native, name, value)
    assert not native.available() and native.backend() == "python" and native.loaded_path() == ""
    assert native.parse_kmsg("6,1,2,-;x") is None
    assert native.scan_links_ragged([1], [0], [0, 1]) is None
    assert native.prefilter_init(["xid"]) is False and native.prefilter_match("xid") is None
    assert type(deduper_mod.default_deduper()) is deduper_mod.Deduper
    with pytest.raises(RuntimeError, match="not available"):
        native.NativeDeduper(1.0, 1)


def test_a_build_after_a_failed_load_is_found(built, monkeypatch, tmp_path):
    monkeypatch.delenv("TPUD_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    for name, value in (("_LIB", None), ("_TRIED", False), ("_PATH", "")):
        monkeypatch.setattr(native, name, value)
    assert native.backend() == "python"
    path = native.build()
    assert path == tmp_path / "b" / "libtpud_native.so"
    assert native.backend() == "native" and native.loaded_path() == str(path)


# -- kmsg parser -------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_the_native_parser_equals_both_python_parsers(lib, monkeypatch, i):
    line = RECORDS[i]
    monkeypatch.setattr(ref_watcher, "_native_parse", None)
    monkeypatch.setattr(watcher, "_native_parse", None)
    py = _fields(watcher.parse_line(line, BOOT))
    assert py == _fields(ref_watcher.parse_line(line, BOOT))
    monkeypatch.setattr(watcher, "_native_parse", native.parse_kmsg)
    assert _fields(watcher.parse_line(line, BOOT)) == py


def test_the_corpus_parses_to_its_own_messages(lib):
    for rec, ln in zip(RECORDS, CORPUS):
        prio, fac, seq, ts_us, msg = native.parse_kmsg(rec)
        assert msg == ln and (prio, fac) == (int(rec.split(",")[0]) & 7, int(rec.split(",")[0]) >> 3)


@pytest.mark.parametrize("line", OVERFLOW)
def test_the_native_parser_clamps_past_int64_as_the_reference_s_does(lib, monkeypatch, line):
    monkeypatch.setattr(watcher, "_native_parse", None)
    py = watcher.parse_line(line, BOOT)
    monkeypatch.setattr(watcher, "_native_parse", native.parse_kmsg)
    nat = watcher.parse_line(line, BOOT)
    assert max(nat.sequence, nat.timestamp_us) == 2**63 - 1
    assert max(py.sequence, py.timestamp_us) == 99999999999999999999


def test_a_record_s_trailing_newline_is_stripped_before_the_native_parser(lib, monkeypatch):
    # every /dev/kmsg read ends in a newline; the C parser keeps it in the
    # message, which the reference's native path passes on (ROADMAP C3)
    rec = "3,9,12,-;NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus.\n"
    assert native.parse_kmsg(rec)[4].endswith("bus.\n")
    monkeypatch.setattr(watcher, "_native_parse", native.parse_kmsg)
    m = watcher.parse_line(rec, BOOT)
    assert m.message.endswith("bus.") and m.raw == rec[:-1]


# -- deduper -----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_the_native_deduper_runs_in_lockstep_with_both_python_ones(lib, seed):
    rng = np.random.default_rng(seed)
    clock = [0.0]
    now = lambda: clock[0]  # noqa: E731
    ttl, cap = float(rng.integers(20, 80)), int(rng.integers(4, 16))
    nat = deduper_mod.NativeBackedDeduper(ttl, cap, time_now_fn=now)
    py = deduper_mod.Deduper(ttl, cap, time_now_fn=now)
    ref = RefDeduper(ttl, cap, time_now_fn=now)
    for step in range(400):
        clock[0] += float(rng.exponential(3.0))
        msg, ts = f"m{int(rng.integers(0, 24))}", float(rng.integers(0, 3))
        got = (nat.seen_before(msg, ts), py.seen_before(msg, ts), ref.seen_before(msg, ts))
        assert got[0] == got[1] == got[2], step
        assert len(nat) == len(py) == len(ref), step
    assert (nat.backend, py.backend) == ("native", "python")


def test_the_native_deduper_evicts_oldest_first(lib):
    nd = native.NativeDeduper(ttl_seconds=1e9, max_entries=16)
    for i in range(100):
        nd.seen(f"k{i}", float(i))
    assert len(nd) == 16
    assert all(nd.seen(f"k{i}", 100.0) for i in range(84, 100))
    assert nd.seen("k83", 100.0) is False


def test_the_kmsg_syncer_takes_the_native_deduper_when_loaded(lib):
    assert type(deduper_mod.default_deduper()) is deduper_mod.NativeBackedDeduper
    assert type(Syncer(lambda line: None, bucket=None).deduper) is deduper_mod.NativeBackedDeduper


# -- catalog prefilter ---------------------------------------------------------------

ORGANIC_HOST = [
    "systemd[1]: Started Session 4 of user root.", "EXT4-fs (sda1): mounted filesystem",
    "e1000e 0000:00:19.0 eth0: NIC Link is Up 1000 Mbps", "CPU0: Core temperature above threshold",
    "mlx5_core 0000:3b:00.0: Port module event: module 0, Cable plugged",
    "XID xid XiD", "nvidia-nvswitch0: SXid (PCI:0000:05:00.0): 12028", "x" * 8191,
]
# a line past the native scan's 8 KiB buffer passes it by design (never
# dropped); the catalog walk behind it still matches nothing
LONG = "x" * 8192


@pytest.fixture()
def armed(lib, monkeypatch):
    monkeypatch.setattr(catalog, "_NATIVE_PREFILTER", native.prefilter_init(catalog.PREFILTER_TOKENS))
    assert catalog._NATIVE_PREFILTER
    return catalog


@pytest.mark.parametrize("line", CORPUS + ORGANIC_HOST, ids=range(len(CORPUS) + len(ORGANIC_HOST)))
def test_the_native_prefilter_equals_the_regex(armed, line):
    assert native.prefilter_match(line) == (catalog._PREFILTER.search(line) is not None)


def test_a_line_past_the_native_buffer_is_never_dropped(armed):
    assert native.prefilter_match(LONG) is True and catalog._PREFILTER.search(LONG) is None
    assert catalog.match(LONG) is None


def test_matching_with_the_native_prefilter_equals_matching_without(armed, monkeypatch):
    lines = CORPUS + ORGANIC_HOST + [LONG]
    with_native = [catalog.match(ln) for ln in lines]
    monkeypatch.setattr(catalog, "_NATIVE_PREFILTER", False)
    without = [catalog.match(ln) for ln in lines]
    assert [(m.entry.name, m.gpu_id) if m else None for m in with_native] == \
        [(m.entry.name, m.gpu_id) if m else None for m in without]
    assert sum(m is not None for m in without) == sum(len(v) for v in corpus.ORGANIC.values())


def test_an_empty_token_set_does_not_arm_the_prefilter(lib):
    assert native.prefilter_init([]) is False and native.prefilter_match("xid") is None


# -- NVLinkStore's ragged scan ---------------------------------------------------------

def _history(seed, links=6, steps=40):
    rng = np.random.default_rng(seed)
    counters = np.zeros((links, 3), int)
    out = []
    for t in range(steps):
        snap = []
        for k in range(links):
            if rng.random() < 0.05:
                counters[k] = 0  # a driver reload resets the counters
            counters[k] += rng.integers(0, 3, 3) * (rng.random() < 0.3)
            down = rng.random() < (0.3 if k % 3 == 0 else 0.02)
            snap.append(dict(gpu=k // 3, link=k % 3, state="down" if down else "up",
                             tx_errors=int(counters[k, 0]), rx_errors=int(counters[k, 1]),
                             crc_errors=int(counters[k, 2])))
        out.append((1000.0 + 30 * t, snap))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_the_native_scan_equals_the_python_walk_and_the_reference(lib, seed, tmp_path):
    hist = _history(seed)
    port_db, ref_db = DB(str(tmp_path / "p.state")), RefDB(str(tmp_path / "r.state"))
    port, ref = NVLinkStore(port_db), ICIStore(ref_db)
    ref.native_enabled = False  # the reference's Python walk
    for store in (port, ref):
        store.time_now_fn = lambda: hist[-1][0] + 1
    for ts, snap in hist:
        port.insert_snapshot([NVLinkSnapshot(gpu_id=s["gpu"], link_id=s["link"], state=s["state"],
                                             tx_errors=s["tx_errors"], rx_errors=s["rx_errors"],
                                             crc_errors=s["crc_errors"]) for s in snap], ts=ts)
        ref.insert_snapshot([ICILinkSnapshot(chip_id=s["gpu"], link_id=s["link"], state=s["state"],
                                             tx_errors=s["tx_errors"], rx_errors=s["rx_errors"],
                                             crc_errors=s["crc_errors"]) for s in snap], ts=ts)
    if seed % 2:
        port.set_tombstone("gpu0/nvlink1", ts=hist[10][0])
        ref.set_tombstone("chip0/ici1", ts=hist[10][0])
    results = {}
    for window in (600.0, 3600.0):
        nat = port.scan(window)
        assert port.backend == "native"
        port.native_enabled = False
        py = port.scan(window)
        assert port.backend == "python"
        port.native_enabled = True
        r = ref.scan(window)
        assert nat == py
        assert {link_name(k): dataclasses.astuple(v)[1:] for k, v in r.links.items()} == \
            {k: dataclasses.astuple(v)[1:] for k, v in nat.links.items()}
        results[window] = nat
    assert any(v.drops for v in results[3600.0].links.values())
    port_db.close()
    ref_db.close()


def test_the_ragged_scan_of_empty_and_single_sample_links(lib):
    assert native.scan_links_ragged([], [], [0]) == []
    one = native.scan_links_ragged([0, 1, 1, 0], [5, 3, 4, 9], [0, 1, 1, 4])
    assert one == [
        {"drops": 0, "flaps": 0, "currently_down": True, "samples": 1, "counter_delta": 0},
        {"drops": 0, "flaps": 0, "currently_down": False, "samples": 0, "counter_delta": 0},
        {"drops": 1, "flaps": 0, "currently_down": True, "samples": 3, "counter_delta": 6},
    ]
