"""``fleet_scan`` across n devices: the port's split (gpud_tpu_torch/
fleet_scan.py ``_classify_split``, which ``device=None`` takes on a host
with more than one card) against the reference's sharded branch
(gpud_tpu/fleet_scan.py:236-253) at the same n.

Under conftest's 8 virtual CPU devices the reference shards over all 8; it
is held at 2 and 3 by narrowing ``jax.devices`` as its own test pins one
device (tests/test_fleet_scan.py:220-231). The port's split runs on n CPU
devices (``_scan_devices`` patched to list the CPU n times); on the card
each block is one kernel launch (chip_smoke.py's fleet phase counts them).
Host DBs are written by the reference's ICIStore with up/down states only:
the reference's sharded branch reads other states differently (ROADMAP,
the logged quirk of its ``scan_links``)."""

import jax
import numpy as np
import pytest
import torch

from gpud_tpu import fleet_scan as jax_fs
from gpud_tpu.components.tpu.ici_store import ICIStore
from gpud_tpu.sqlite import DB
from gpud_tpu.tpu.instance import ICILinkSnapshot, LinkState

from gpud_tpu_torch import fleet_scan as torch_fs
from gpud_tpu_torch.ops.packed_scan import packed_from_numpy, scan_links_packed
from gpud_tpu_torch.ops.window_scan import classify_links

NOW = 1_700_000_000.0
MINUTES = 30


def _host_db(path, n_chips, n_links, faults):
    """One host's 30 minutes of link snapshots; ``faults`` maps a link's
    index to "down" (from minute 20), "flappy" (down 2 of every 4 minutes)
    or "crc" (50 CRC errors a minute)."""
    db = DB(str(path))
    store = ICIStore(db)
    for minute in range(MINUTES):
        links = []
        for i in range(n_chips * n_links):
            kind = faults.get(i)
            down = (kind == "down" and minute >= 20) or (kind == "flappy" and minute % 4 < 2)
            links.append(ICILinkSnapshot(
                chip_id=i // n_links, link_id=i % n_links,
                state=LinkState.DOWN if down else LinkState.UP,
                crc_errors=minute * 50 if kind == "crc" else 0))
        store.insert_snapshot(links, ts=NOW - (MINUTES - minute) * 60)
    db.close()
    return str(path)


# (hosts of (chips, links per chip)) giving L = 1, 7, 9 and 13 links
FLEETS = {
    1: [(1, 1)],
    7: [(7, 1)],
    9: [(3, 3)],
    13: [(2, 2), (3, 3)],
}
FAULTS = ("down", "flappy", "crc")


def _fleet(tmp_path, L):
    paths, offset = [], 0
    for h, (chips, links) in enumerate(FLEETS[L]):
        n = chips * links
        faults = {i: FAULTS[(offset + i) % 4] for i in range(n) if (offset + i) % 4 < 3}
        paths.append(_host_db(tmp_path / f"host{h}.db", chips, links, faults))
        offset += n
    return paths


def _reference(paths, n, monkeypatch, **kw):
    devs = jax.devices()[:n]
    assert len(devs) == n  # conftest's 8 virtual devices
    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda *a: devs)
        return jax_fs.fleet_scan(paths, window_seconds=3600, now=NOW, **kw)


def _port(paths, n, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.setattr(torch_fs, "_scan_devices", lambda device: [torch.device("cpu")] * n)
        return torch_fs.fleet_scan(paths, window_seconds=3600, now=NOW, **kw)


@pytest.mark.parametrize("L", sorted(FLEETS))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_split_over_n_devices_equals_the_references_sharded_scan(tmp_path, monkeypatch,
                                                                     n, L):
    paths = _fleet(tmp_path, L)
    ref = _reference(paths, n, monkeypatch)
    got = _port(paths, n, monkeypatch)
    assert len(got["links"]) == L
    for key in ("window_seconds", "links", "summary", "truncated_links"):
        assert got[key] == ref[key], key
    assert got["devices"] == ref["devices"] == n
    if L >= 3:  # a fault of each kind: every class is exercised
        assert set(got["links"].values()) == {"healthy", "degraded", "unhealthy"}


@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_split_honours_the_thresholds_as_the_reference(tmp_path, monkeypatch, n):
    paths = _fleet(tmp_path, 13)
    for kw in (dict(flap_threshold=1, crc_threshold=2000),
               dict(flap_threshold=10, crc_threshold=10)):
        ref = _reference(paths, n, monkeypatch, **kw)
        got = _port(paths, n, monkeypatch, **kw)
        assert (got["links"], got["summary"], got["devices"]) == (
            ref["links"], ref["summary"], ref["devices"])


@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_empty_fleet_reports_no_device_as_the_reference(tmp_path, monkeypatch, n):
    paths = _fleet(tmp_path, 9)
    ref = jax_fs.fleet_scan(paths, window_seconds=60, now=NOW + 10 * 86400)
    with monkeypatch.context() as m:
        m.setattr(torch_fs, "_scan_devices", lambda device: [torch.device("cpu")] * n)
        got = torch_fs.fleet_scan(paths, window_seconds=60, now=NOW + 10 * 86400)
    assert got == ref
    assert got["links"] == {} and got["devices"] == 0


def _random_history(rng, L, T=24):
    states = rng.integers(0, 2, size=(L, T)).astype(np.int8)
    counters = np.cumsum(rng.integers(0, 40, size=(L, T)), axis=1).astype(np.int32)
    lengths = rng.integers(0, T + 1, size=L)
    valid = np.arange(T)[None, :] < lengths[:, None]
    return states, counters, valid


@pytest.mark.parametrize("L", [1, 7, 9, 13, 64])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_each_device_scans_one_block_and_the_classes_equal_the_unsplit_scan(monkeypatch, n, L):
    rng = np.random.default_rng(1000 * n + L)
    states, counters, valid = _random_history(rng, L)
    whole = classify_links(scan_links_packed(*packed_from_numpy(
        states, counters, valid, "cpu"))).numpy()
    blocks = []

    def recording(s, c, v):
        blocks.append((s.shape[0], s.device, bool(v.any())))
        return scan_links_packed(s, c, v)

    monkeypatch.setattr(torch_fs, "scan_links_packed", recording)
    got = torch_fs._classify_split([torch.device("cpu")] * n, states, counters, valid)
    np.testing.assert_array_equal(got, whole)
    assert got.dtype == np.int32 and got.shape == (L,)
    # one scan per device, each of the padded L / n rows
    rows = -(-L // n)
    assert [b[0] for b in blocks] == [rows] * n
    assert all(b[1].type == "cpu" for b in blocks)
    if L < n:  # the padding alone fills the last blocks: all invalid, all class 0
        assert [b[2] for b in blocks[L:]] == [False] * (n - L)


def test_scan_devices_takes_every_card_only_for_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert torch_fs._scan_devices(None) == [torch.device("cuda", i) for i in range(4)]
    # an explicit device keeps the one-device path
    assert torch_fs._scan_devices("cpu") == [torch.device("cpu")]
    assert torch_fs._scan_devices("cuda:1") == [torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_fs._scan_devices(None) == [torch.device("cuda")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_fs._scan_devices(None)
