"""The port's OS adapters of the host checks against the reference's:
gpud_tpu_torch/pstore.py, cri.py, providers/detect.py, asn.py, netutil.py,
blockdev.py, nfs_checker.py, procfs.py, and the rest of host.py and
process.py.

The cases of tests/test_pstore_matrix.py, test_cri.py,
test_cri_codec_hostile.py, test_providers_matrix.py, test_process_host.py and
test_inotify_host_edges.py run on both packages with the same fixtures; the
pstore tables, the CRI codec's bytes, the ``BlockDeviceInfo`` trees and every
result must be equal. The CRI client talks to a fake CRI server on
localhost; no case opens a public socket, sleeps or spawns a process (the
runners are held to the reference on the ``subprocess.run`` call they make).
"""

import dataclasses
import json
import os
import subprocess
import threading
from concurrent import futures
from types import SimpleNamespace

import pytest

import gpud_tpu.asn as r_asn
import gpud_tpu.blockdev as r_blockdev
import gpud_tpu.cri as r_cri
import gpud_tpu.host as r_host
import gpud_tpu.netutil as r_netutil
import gpud_tpu.nfs_checker as r_nfs
import gpud_tpu.process as r_process
import gpud_tpu.providers.detect as r_detect
import gpud_tpu.pstore as r_pstore
from gpud_tpu.components.base import TpudInstance as RefTpud
from gpud_tpu.components.host_extra import ContainerdComponent as RefContainerd
from gpud_tpu.inotify import InotifyWatch as RefInotifyWatch
from gpud_tpu.sqlite import DB as RefDB

import gpud_tpu_torch.asn as p_asn
import gpud_tpu_torch.blockdev as p_blockdev
import gpud_tpu_torch.cri as p_cri
import gpud_tpu_torch.host as p_host
import gpud_tpu_torch.netutil as p_netutil
import gpud_tpu_torch.nfs_checker as p_nfs
import gpud_tpu_torch.process as p_process
import gpud_tpu_torch.providers.detect as p_detect
import gpud_tpu_torch.pstore as p_pstore
from gpud_tpu_torch import procfs
from gpud_tpu_torch.api.v1.types import BlockDeviceInfo
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.components.host_extra import ContainerdComponent
from gpud_tpu_torch.inotify import InotifyWatch
from gpud_tpu_torch.sqlite import DB

from torch_parity import assert_result_parity

REF = SimpleNamespace(name="ref", pstore=r_pstore, cri=r_cri, detect=r_detect, asn=r_asn,
                      netutil=r_netutil, blockdev=r_blockdev, nfs=r_nfs, host=r_host,
                      process=r_process, DB=RefDB, Containerd=RefContainerd, Tpud=RefTpud)
PORT = SimpleNamespace(name="port", pstore=p_pstore, cri=p_cri, detect=p_detect, asn=p_asn,
                       netutil=p_netutil, blockdev=p_blockdev, nfs=p_nfs, host=p_host,
                       process=p_process, DB=DB, Containerd=ContainerdComponent,
                       Tpud=TpudInstance)
PKGS = [REF, PORT]


def both(fn, *args):
    return fn(REF, *args), fn(PORT, *args)


def outcome(fn, *args):
    """The value, or the exception's type and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001
        return ("raised", type(e).__name__, str(e))


# -- pstore ---------------------------------------------------------------------------

PANIC_DUMP = """\
<6>[  100.000000] systemd[1]: started something
<0>[  245.123456] Kernel panic - not syncing: Fatal exception in interrupt
<0>[  245.123999] CPU: 3 PID: 0 Comm: swapper/3 Tainted: G W
<0>[  245.124500] Call Trace:
"""
OOPS_DUMP = """\
<4>[  881.000000] BUG: unable to handle page fault for address: ffffdead
<4>[  881.000100] Oops: 0002 [#1] PREEMPT SMP NOPTI
<4>[  881.000200] RIP: 0010:nv_dma_complete+0x24/0x90 [nvidia]
"""
GPF_DUMP = "<1>[ 12.0] general protection fault, probably for non-canonical address\n"
HARD_LOCKUP_DUMP = "<0>[ 55.5] watchdog: hard LOCKUP on cpu 7\n"
BENIGN_DUMP = "<6>[    1.000000] Linux version 6.1.0\n<6>[    2.0] systemd[1]: Reached target\n"
MANY_DUMP = "".join(f"<0>[ {i}.0] BUG: repeated fault {i}\n" for i in range(50))


def write(root, name, content, mtime=None):
    root.mkdir(parents=True, exist_ok=True)
    p = root / name
    p.write_text(content)
    if mtime is not None:
        os.utime(p, (mtime, mtime))
    return p


def records(recs, root):
    return [(os.path.relpath(r.path, root), r.mtime, r.kind, r.excerpt) for r in recs]


@pytest.mark.parametrize("files", [
    [("dmesg-efi-172000000001", PANIC_DUMP, None)],
    [("dmesg-efi-172000000001", OOPS_DUMP, None)],
    [("dmesg-efi-1", GPF_DUMP, None)],
    [("dmesg-efi-1", HARD_LOCKUP_DUMP, None)],
    [("dmesg-efi-2", BENIGN_DUMP, None)],
    [("dmesg-efi-9", MANY_DUMP, None)],
    [("pmsg-ramoops-0", "userspace junk", None), ("notes.txt", "operator notes", None),
     ("console-ramoops-0", PANIC_DUMP, None)],
    [("dmesg-efi-2", OOPS_DUMP, 2000), ("196000000/000/dmesg-efi-1", PANIC_DUMP, 1000)],
    [("DMESG-upper", PANIC_DUMP, 5)],
], ids=["panic", "oops", "gpf", "hard-lockup", "benign", "five-matches", "non-crash-ignored",
        "mtime-order-nested", "case-insensitive"])
def test_pstore_classification_matrix(tmp_path, files):
    for name, content, mtime in files:
        write(tmp_path / os.path.dirname(name), os.path.basename(name), content, mtime)
    ref, port = both(lambda pkg: records(pkg.pstore.read_crash_files(str(tmp_path)), tmp_path))
    assert port == ref and port


def test_pstore_unreadable_entry_is_skipped(tmp_path):
    (tmp_path / "dmesg-efi-3").symlink_to(tmp_path / "gone")
    write(tmp_path, "dmesg-efi-4", PANIC_DUMP, 10)
    ref, port = both(lambda pkg: records(pkg.pstore.read_crash_files(str(tmp_path)), tmp_path))
    assert port == ref and [r[0] for r in port] == ["dmesg-efi-4"]


def test_pstore_env_override_and_missing_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUD_PSTORE_DIR", str(tmp_path / "nope"))
    assert p_pstore.read_crash_files() == r_pstore.read_crash_files() == []
    monkeypatch.setenv("TPUD_PSTORE_DIR", str(tmp_path))
    write(tmp_path, "dmesg-efi-1", PANIC_DUMP)
    assert records(p_pstore.read_crash_files(), tmp_path) == \
        records(r_pstore.read_crash_files(), tmp_path)
    monkeypatch.delenv("TPUD_PSTORE_DIR")
    assert p_pstore.pstore_dir() == r_pstore.pstore_dir() == "/var/lib/systemd/pstore"
    assert p_pstore.pstore_dir("/x") == "/x" and p_pstore.TABLE == r_pstore.TABLE


def test_pstore_history_dedupes_across_restarts(tmp_path):
    dumps = tmp_path / "dumps"
    write(dumps, "dmesg-efi-1", PANIC_DUMP, mtime=1000)

    def run(pkg):
        db = pkg.DB(str(tmp_path / f"{pkg.name}.db"))
        h1 = pkg.pstore.PstoreHistory(db)
        out = [len(h1.record_new(pkg.pstore.read_crash_files(str(dumps))))]
        h2 = pkg.pstore.PstoreHistory(db)  # a restart: the same dump is old
        out.append(len(h2.record_new(pkg.pstore.read_crash_files(str(dumps)))))
        write(dumps, "dmesg-efi-1", PANIC_DUMP, mtime=2000)  # rewritten: a new crash
        out.append(len(h2.record_new(pkg.pstore.read_crash_files(str(dumps)))))
        write(dumps, "dmesg-efi-1", PANIC_DUMP, mtime=1000)
        out.append([dataclasses.astuple(r) for r in h2.all()])
        out.append(db.query("SELECT path, mtime, kind, excerpt FROM tpud_pstore_v0_1 "
                            "ORDER BY mtime"))
        out.append(db.query("SELECT sql FROM sqlite_master WHERE name = 'tpud_pstore_v0_1'"))
        db.close()
        return out

    ref, port = both(run)
    assert [list(map(tuple, x)) if isinstance(x, list) else x for x in port] == \
        [list(map(tuple, x)) if isinstance(x, list) else x for x in ref]
    assert port[:3] == [1, 0, 1] and len(port[3]) == 2


# -- CRI codec --------------------------------------------------------------------------

@pytest.mark.parametrize("v", [0, 1, 127, 128, 300, 2**32, 2**63 - 1])
def test_cri_varint_boundary_values(v):
    for field in (1, 15, 16, 999):
        assert p_cri.encode_field_varint(field, v) == r_cri.encode_field_varint(field, v)
        data = p_cri.encode_field_varint(field, v)
        assert p_cri.parse_message(data) == r_cri.parse_message(data) == {field: [v]}


ENCODED = [
    lambda m: m.encode_field_str(1, "abc") + m.encode_field_varint(6, 1)
    + m.encode_field_bytes(3, m.encode_field_str(1, "inner")) + m.encode_field_varint(7, 1700000000),
    lambda m: m.encode_field_str(1, "a") + m.encode_field_str(1, "b") + m.encode_field_varint(2, 7),
    lambda m: m.encode_field_str(999, "future") + m.encode_field_varint(1, 5),
    lambda m: m.encode_field_bytes(1, m.encode_field_str(1, "id-1") + m.encode_field_varint(2, 1)) * 2,
    lambda m: m.encode_field_bytes(1, b"\xff\xfe"),
    lambda m: m.encode_field_str(2, "ünïcode ✓"),
    lambda m: b"",
    lambda m: b"\x0d\x01\x02\x03\x04" + b"\x09" + bytes(range(8)),  # fixed32 + fixed64
]


@pytest.mark.parametrize("i", range(len(ENCODED)))
def test_cri_codec_bytes_and_parse(i):
    ref, port = ENCODED[i](r_cri), ENCODED[i](p_cri)
    assert port == ref
    assert p_cri.parse_message(port) == r_cri.parse_message(ref)


@pytest.mark.parametrize("blob", [
    b"\xff" * 16,
    b"\x0a\xff" + b"x" * 4,
    b"\x0a",
    r_cri.encode_varint(1 << 40),
    b"\x0d\x01\x02",
    b"\x09\x01",
    b"\x0a" + r_cri.encode_varint(1 << 30) + b"abc",
    r_cri.encode_field_str(1, "abcdef")[:-2],
    b"\x0b\x00",  # start-group wire type
])
def test_cri_hostile_blobs_raise_cleanly(blob):
    ref, port = outcome(r_cri.parse_message, blob), outcome(p_cri.parse_message, blob)
    assert port == ref and port[:2] == ("raised", "ValueError")


def test_cri_field_helpers_and_constants():
    msg = p_cri.encode_field_str(1, "x") + p_cri.encode_field_varint(2, 3)
    f = p_cri.parse_message(msg)
    for name, args in (("_first_str", (f, 1)), ("_first_str", (f, 9)), ("_first_int", (f, 2)),
                       ("_first_int", (f, 1)), ("_first_int", (f, 9))):
        assert getattr(p_cri, name)(*args) == getattr(r_cri, name)(*args)
    entry = p_cri.encode_field_str(1, "k") + p_cri.encode_field_str(2, "v")
    assert p_cri._parse_map_entry(entry) == r_cri._parse_map_entry(entry) == ("k", "v")
    assert (p_cri.DEFAULT_SOCKET, p_cri.CONTAINER_STATES, p_cri.SANDBOX_STATES) == \
        (r_cri.DEFAULT_SOCKET, r_cri.CONTAINER_STATES, r_cri.SANDBOX_STATES)


# -- CRI client over a fake server on localhost ------------------------------------------

grpc = pytest.importorskip("grpc")
enc = r_cri


def _container(cid, name, state, image="img:1"):
    return enc.encode_field_bytes(1, enc.encode_field_str(1, cid)
                                  + enc.encode_field_str(2, f"sandbox-{cid}")
                                  + enc.encode_field_bytes(3, enc.encode_field_str(1, name))
                                  + enc.encode_field_bytes(4, enc.encode_field_str(1, image))
                                  + enc.encode_field_varint(6, state)
                                  + enc.encode_field_varint(7, 1700000000)
                                  + enc.encode_field_bytes(8, enc.encode_field_str(
                                      1, "io.kubernetes.pod.name") + enc.encode_field_str(2, name)))


def _sandbox(sid, name, ns, state):
    return enc.encode_field_bytes(1, enc.encode_field_str(1, sid)
                                  + enc.encode_field_bytes(2, enc.encode_field_str(1, name)
                                                           + enc.encode_field_str(3, ns))
                                  + enc.encode_field_varint(3, state)
                                  + enc.encode_field_varint(4, 1700000001))


class FakeCRI(grpc.GenericRpcHandler):
    """tests/test_cri.py's fake: serves one API version (or none)."""

    def __init__(self, api="v1"):
        self.api = api

    def service(self, details):
        method = details.method
        if not method.startswith(f"/runtime.{self.api}."):
            return None  # UNIMPLEMENTED

        def handler(req, ctx):
            if method.endswith("/Version"):
                return (enc.encode_field_str(1, "0.1.0") + enc.encode_field_str(2, "containerd")
                        + enc.encode_field_str(3, "1.7.0") + enc.encode_field_str(4, "v1"))
            if method.endswith("/ListContainers"):
                return (_container("c1", "gpu-worker", 1) + _container("c2", "sidecar", 2)
                        + _container("c3", "init", 0) + _container("c4", "odd", 9))
            if method.endswith("/ListPodSandbox"):
                return _sandbox("s1", "gpu-pod", "default", 0) + _sandbox("s2", "x", "y", 1)
            ctx.abort(grpc.StatusCode.UNIMPLEMENTED, "nope")

        return grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=lambda b: b, response_serializer=lambda b: b)


@pytest.fixture(scope="module")
def cri_servers():
    """One fake server per API flavour for the whole file: v1, v1alpha2 only,
    and one that serves no CRI at all."""
    out, servers = {}, []
    for api in ("v1", "v1alpha2", "none"):
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        server.add_generic_rpc_handlers((FakeCRI(api),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        servers.append(server)
        out[api] = f"127.0.0.1:{port}"
    yield out
    for s in servers:
        s.stop(grace=None)


@pytest.mark.parametrize("api", ["v1", "v1alpha2"])
def test_cri_version_and_lists(cri_servers, api):
    def run(pkg):
        c = pkg.cri.CRIClient(target=cri_servers[api])
        try:
            return c.snapshot(), c._api_version
        finally:
            c.close()

    ref, port = both(run)
    assert port == ref and port[1] == api
    snap = port[0]
    assert [x["state"] for x in snap["containers"]] == ["running", "exited", "created", "unknown"]
    assert snap["containers"][0]["labels"] == {"io.kubernetes.pod.name": "gpu-worker"}
    assert snap["sandboxes"][1]["state"] == "notready"


def test_cri_probe(cri_servers):
    for target in (cri_servers["v1"], cri_servers["none"], "127.0.0.1:1"):
        ref = r_cri.probe(target=target, timeout=2.0)
        port = p_cri.probe(target=target, timeout=2.0)
        assert port == ref
    assert p_cri.probe(target=cri_servers["none"], timeout=2.0) == {"unserved": True}
    assert p_cri.probe(target="127.0.0.1:1", timeout=0.5) is None
    assert p_cri.grpc_available() is r_cri.grpc_available() is True


def containerd_run(pkg, sock, target, checks, grpc_ok=True):
    c = pkg.Containerd(pkg.Tpud())
    c.socket_path = str(sock)
    c.cri_target = target
    orig = pkg.cri.grpc_available
    pkg.cri.grpc_available = lambda: grpc_ok
    try:
        return [c.check() for _ in range(checks)]
    finally:
        pkg.cri.grpc_available = orig
        c.close()


@pytest.mark.parametrize("target, checks, grpc_ok, last", [
    ("v1", 1, True, "Healthy"),
    ("v1alpha2", 2, True, "Healthy"),
    ("none", 5, True, "Healthy"),
    ("dead", 3, True, "Degraded"),
    ("dead", 2, True, "Healthy"),
    ("v1", 1, False, "Healthy"),
], ids=["cri", "cri-v1alpha2", "cri-not-served", "cri-dead", "cri-dead-damped", "no-grpcio"])
def test_containerd_component_over_cri(tmp_path, cri_servers, target, checks, grpc_ok, last):
    sock = tmp_path / "containerd.sock"
    sock.write_text("")
    addr = "127.0.0.1:1" if target == "dead" else cri_servers[target]
    ref, port = both(containerd_run, sock, addr, checks, grpc_ok)
    for r, p in zip(ref, port):
        assert_result_parity(r, p)
    assert port[-1].health == last


def test_containerd_cri_strikes_reset_when_socket_goes(tmp_path):
    def run(pkg):
        sock = tmp_path / f"{pkg.name}.sock"
        sock.write_text("")
        c = pkg.Containerd(pkg.Tpud())
        c.socket_path = str(sock)
        c.cri_target = "127.0.0.1:1"
        out = [c.check(), c.check(), c._cri_misses]
        sock.unlink()
        out += [c.check(), c._cri_misses]
        sock.write_text("")
        out.append(c.check())
        c.close()
        return out

    ref, port = both(run)
    for r, p in zip(ref, port):
        if isinstance(r, int):
            assert p == r
        else:
            assert_result_parity(r, p)
    assert (port[2], port[4], port[-1].health) == (2, 0, "Healthy")


# -- providers --------------------------------------------------------------------------

def getter(routes):
    def get(url, headers, timeout=1.0):
        for frag, resp in routes.items():
            if frag in url:
                if isinstance(resp, Exception):
                    raise resp
                return resp
        raise OSError(f"unrouted {url}")

    return get


GCP_FULL = {"instance/zone": "projects/12345/zones/us-east5-b",
            "machine-type": "projects/12345/machineTypes/a3-highgpu-8g",
            "accelerator-type": "v5p-256", "tpu-env": "TPU_CHIPS_PER_HOST: '4'"}
DETECTOR_CASES = {
    "gcp-full": ("detect_gcp", GCP_FULL),
    "gcp-partial": ("detect_gcp", {"instance/zone": "projects/1/zones/europe-west4-a",
                                   "machine-type": "projects/1/machineTypes/n2-standard-8"}),
    "gcp-zone-no-dash": ("detect_gcp", {"instance/zone": "zones/local"}),
    "gcp-absent": ("detect_gcp", {}),
    "azure": ("detect_azure", {"metadata/instance/compute": json.dumps(
        {"location": "eastus2", "zone": "1", "vmSize": "ND96isr_H100_v5"})}),
    "azure-absent": ("detect_azure", {}),
    "azure-malformed": ("detect_azure", {"metadata/instance/compute": "<html>"}),
    "oci": ("detect_oci", {"canonicalRegionName": "us-ashburn-1", "shape": "BM.GPU.H100.8",
                           "availabilityDomain": "AD-1"}),
    "oci-partial": ("detect_oci", {"canonicalRegionName": "eu-frankfurt-1"}),
    "oci-absent": ("detect_oci", {}),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_provider_detectors(case):
    fn, routes = DETECTOR_CASES[case]
    ref, port = both(lambda pkg: getattr(pkg.detect, fn)(get_fn=getter(routes)))
    assert (None if port is None else dataclasses.asdict(port)) == \
        (None if ref is None else dataclasses.asdict(ref))


@pytest.mark.parametrize("doc, token", [
    (json.dumps({"region": "us-west-2", "availabilityZone": "us-west-2b",
                 "instanceType": "p5.48xlarge"}), "tok-123"),
    ("<html>error</html>", ""),
])
def test_provider_aws(monkeypatch, doc, token):
    seen = []
    for pkg in PKGS:
        monkeypatch.setattr(pkg.detect, "_imds_v2_token", lambda: token)

    def get(url, headers, timeout=1.0):
        seen.append(dict(headers))
        assert "instance-identity/document" in url
        return doc

    ref, port = both(lambda pkg: pkg.detect.detect_aws(get_fn=get))
    assert (None if port is None else dataclasses.asdict(port)) == \
        (None if ref is None else dataclasses.asdict(ref))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("files", [
    {"parent-id": "project-abc\n", "instance-id": "computeinstance-xyz\n",
     "gpu-cluster-id": "cluster-7\n"},
    {"parent-id": "p\n", "instance-id": "i\n", "org-id": "org-9\n"},
    {"parent-id": "p\n"},
    None,
], ids=["nebius", "nscale", "incomplete", "missing"])
def test_provider_metadata_mount(tmp_path, files):
    root = tmp_path / "cloud-metadata"
    if files is not None:
        root.mkdir()
        for name, body in files.items():
            (root / name).write_text(body)
    ref, port = both(lambda pkg: pkg.detect.detect_metadata_mount(root=str(root)))
    assert (None if port is None else dataclasses.asdict(port)) == \
        (None if ref is None else dataclasses.asdict(ref))


@pytest.mark.parametrize("found, asn_info, want", [
    (["aws", "gcp"], None, "gcp"),
    (["oci", "azure"], None, "azure"),
    (["nscale", "nebius"], None, "nebius"),
    ([], SimpleNamespace(provider="hetzner", asn=24940, org="Hetzner Online"), "hetzner"),
    ([], SimpleNamespace(provider="", asn=1, org="Nobody"), "unknown"),
    ([], None, "unknown"),
], ids=["gcp-first", "azure-over-oci", "nebius-over-nscale", "asn", "asn-no-provider",
        "nothing"])
def test_provider_detect_aggregation(monkeypatch, found, asn_info, want):
    for pkg in PKGS:
        monkeypatch.setattr(pkg.detect, "DETECTORS",
                            [lambda p=p, pkg=pkg: pkg.detect.DetectResult(provider=p, region="r")
                             for p in found] or [lambda: None])
        monkeypatch.setattr(pkg.asn, "lookup", lambda ip: asn_info)
    ref, port = both(lambda pkg: pkg.detect.detect(timeout=5.0))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.provider == want


def test_provider_detect_abandons_a_straggler(monkeypatch):
    release = threading.Event()

    def slow():
        release.wait(30)
        return None

    try:
        for pkg in PKGS:
            monkeypatch.setattr(pkg.detect, "DETECTORS", [
                slow, lambda pkg=pkg: pkg.detect.DetectResult(provider="oci", region="r")])
            monkeypatch.setattr(pkg.asn, "lookup", lambda ip: None)
        ref, port = both(lambda pkg: pkg.detect.detect(timeout=0.05))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.provider == "oci"
    finally:
        release.set()


def test_provider_detect_asn_failure_is_unknown(monkeypatch):
    def boom(ip):
        raise RuntimeError("resolver down")

    for pkg in PKGS:
        monkeypatch.setattr(pkg.detect, "DETECTORS", [lambda: None])
        monkeypatch.setattr(pkg.asn, "lookup", boom)
    assert p_detect.detect(timeout=1.0).provider == r_detect.detect(timeout=1.0).provider == \
        "unknown"


# -- asn --------------------------------------------------------------------------------

@pytest.mark.parametrize("doc", [
    {"network": {"autonomous_system": {"asn": 15169, "organization": "Google LLC"}}},
    {"autonomous_system": {"asn": 16509, "name": "AMAZON-02"}},
    {"network": None, "autonomous_system": {"asn": 8075, "organization": "Microsoft"}},
    {"network": {"autonomous_system": {"asn": 31898, "organization": "Oracle Corporation"}}},
    {"network": {"autonomous_system": {"asn": 1, "organization": "Nebius B.V."}}},
    {"network": {"autonomous_system": {"asn": 0, "organization": "Somebody"}}},
    {"network": None},
    {},
    None,
    RuntimeError("offline"),
])
def test_asn_lookup(doc):
    urls = []

    def fetch(url):
        urls.append(url)
        if isinstance(doc, Exception):
            raise doc
        return doc

    for ip in ("", "34.1.2.3"):
        ref, port = r_asn.lookup(ip, fetch_fn=fetch), p_asn.lookup(ip, fetch_fn=fetch)
        assert (None if port is None else dataclasses.asdict(port)) == \
            (None if ref is None else dataclasses.asdict(ref))
    assert urls[0] == urls[1] and urls[2] == urls[3]


# -- netutil ------------------------------------------------------------------------------

def test_netutil_edges_and_local_probes():
    import socket

    assert p_netutil.DEFAULT_EDGES == r_netutil.DEFAULT_EDGES
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]
    try:
        edges = [("open", "127.0.0.1", port), ("closed", "127.0.0.1", 1)]
        got = p_netutil.measure_edges(edges, timeout=1.0)
        want = r_netutil.measure_edges(edges, timeout=1.0)
        assert list(got) == list(want) == ["open", "closed"]
        assert got["closed"] is want["closed"] is None and got["open"] >= 0.0
        assert p_netutil.is_port_open("127.0.0.1", port, timeout=1.0) is True
        assert p_netutil.tcp_rtt_ms("127.0.0.1", 1, timeout=0.5) is None
    finally:
        srv.close()


# -- blockdev --------------------------------------------------------------------------------

def put(path, content):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)


def block_fixture(root):
    b = root / "sys" / "block"
    put(b / "sda" / "size", str(100 * (1 << 30) // 512))
    put(b / "sda" / "removable", "0")
    put(b / "sda" / "queue" / "rotational", "1")
    put(b / "sda" / "device" / "model", "PersistentDisk")
    put(b / "sda" / "sda1" / "size", str(99 * (1 << 30) // 512))
    put(b / "sda" / "sda1" / "partition", "1")
    put(b / "sda" / "sda15" / "size", str((1 << 30) // 512))
    put(b / "sda" / "sda15" / "partition", "15")
    put(b / "sda" / "holders" / "x", "")  # not a partition
    put(b / "loop0" / "size", "1024")
    put(b / "zram0" / "size", "1024")
    put(b / "nvme0n1" / "size", str(375 * (1 << 30) // 512))
    put(b / "nvme0n1" / "queue" / "rotational", "0")
    put(b / "nvme0n1" / "removable", "1")
    put(b / "nvme0n1" / "device" / "model", "nvme_card")
    put(b / "nvme0n1" / "nvme0n1p1" / "size", "2048")
    put(b / "nvme0n1" / "nvme0n1p1" / "partition", "1")
    put(b / "vdb" / "size", "garbage")
    (root / "hostdata").mkdir(exist_ok=True)
    put(root / "proc" / "mounts",
        "/dev/sda1 / ext4 rw,relatime 0 0\n"
        "/dev/sda1 /snap squashfs ro 0 0\n"
        "/dev/nvme0n1p1 /hostdata xfs rw 0 0\n"
        "/dev/vdb /mnt/my\\040disk ext4 ro,errors=remount-ro 0 0\n"
        "/dev/sdc /mnt/café ext4 rw 0 0\n"
        "proc /proc proc rw 0 0\n"
        "short line\n")
    return str(b), str(root / "proc" / "mounts")


@pytest.fixture
def fixed_statvfs(monkeypatch):
    """The same used bytes for a path in both packages (a real statvfs
    of a busy file system moves between two reads)."""
    for mod in (r_blockdev, p_blockdev):
        monkeypatch.setattr(mod, "_statvfs_used", lambda path: 4096 * len(path))


def trees(tree):
    return [d.to_dict() for d in tree]


def test_block_tree_shape_and_mounts(tmp_path, fixed_statvfs):
    root, mounts = block_fixture(tmp_path)
    ref, port = both(lambda pkg: trees(pkg.blockdev.read_block_tree(sys_block_root=root,
                                                                    proc_mounts=mounts)))
    assert port == ref
    assert [d["name"] for d in port] == ["nvme0n1", "sda", "vdb"]
    assert [c["name"] for c in port[1]["children"]] == ["sda1", "sda15"]


def test_block_tree_host_root(tmp_path, fixed_statvfs, monkeypatch):
    block_fixture(tmp_path)
    ref, port = both(lambda pkg: trees(pkg.blockdev.read_block_tree(host_root=str(tmp_path))))
    assert port == ref and port[0]["children"][0]["used_bytes"] == \
        4096 * len(str(tmp_path / "hostdata"))
    monkeypatch.setenv("TPUD_HOST_ROOT", str(tmp_path))
    assert trees(p_blockdev.read_block_tree()) == trees(r_blockdev.read_block_tree()) == port


def test_block_tree_unreadable_root(tmp_path):
    assert p_blockdev.read_block_tree(sys_block_root=str(tmp_path / "x")) == \
        r_blockdev.read_block_tree(sys_block_root=str(tmp_path / "x")) == []


def test_mount_table_and_mounts(tmp_path, monkeypatch):
    _root, mounts = block_fixture(tmp_path)
    rows = lambda pkg: [(e.device, e.mount_point, e.fstype, e.options)  # noqa: E731
                        for e in pkg.blockdev.read_mount_table(mounts)]
    assert rows(PORT) == rows(REF)
    assert ("/dev/vdb", "/mnt/my disk", "ext4", ["ro", "errors=remount-ro"]) in rows(PORT)
    assert p_blockdev.read_mounts(mounts) == r_blockdev.read_mounts(mounts)
    assert p_blockdev.read_mounts(mounts)["sdc"][0] == "/mnt/café"
    monkeypatch.setenv("TPUD_HOST_ROOT", str(tmp_path))
    assert [e.device for e in p_blockdev.read_mount_table()] == \
        [e.device for e in r_blockdev.read_mount_table()]


def test_statvfs_used_and_containers(tmp_path):
    for path in ("/proc", str(tmp_path / "missing")):
        assert p_blockdev._statvfs_used(path) == r_blockdev._statvfs_used(path)
    (tmp_path / ".dockerenv").write_text("")
    assert p_blockdev.detect_containerized(str(tmp_path)) is \
        r_blockdev.detect_containerized(str(tmp_path)) is True
    assert p_blockdev.detect_containerized() == r_blockdev.detect_containerized()


def test_block_device_info_is_the_references():
    node = BlockDeviceInfo(name="sda", size_bytes=10, model="m", rotational=True,
                           children=[BlockDeviceInfo(name="sda1", type="part", mount_point="/")])
    from gpud_tpu.api.v1.types import BlockDeviceInfo as RefInfo

    ref = RefInfo.from_dict(node.to_dict())
    assert ref.to_dict() == node.to_dict()
    assert BlockDeviceInfo.from_dict(ref.to_dict()) == node
    assert [f.name for f in dataclasses.fields(BlockDeviceInfo)] == \
        [f.name for f in dataclasses.fields(RefInfo)]


# -- nfs checker -------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [{}, {"dir": "/x", "ttl_seconds": 5}, {"dir": "/x"}])
def test_nfs_group_validate(cfg):
    assert p_nfs.GroupConfig(**cfg).validate() == r_nfs.GroupConfig(**cfg).validate()


def test_nfs_group_members_and_stale_cleanup(tmp_path):
    def run(pkg):
        d = tmp_path / pkg.name
        d.mkdir()
        now = 10_000.0
        (d / "fresh-peer").write_text(json.dumps({"machine_id": "fresh-peer", "ts": now - 10}))
        (d / "stale-peer").write_text(json.dumps({"machine_id": "stale-peer", "ts": now - 200}))
        (d / "ancient-peer").write_text(json.dumps({"machine_id": "a", "ts": now - 1000}))
        (d / "corrupt-peer").write_text("{not json")
        (d / "half.tmp").write_text("x")
        checker = pkg.nfs.NFSChecker("me", [pkg.nfs.GroupConfig(dir=str(d), ttl_seconds=60)])
        checker.time_now_fn = lambda: now
        rep = checker.check_all()[str(d)]
        return (rep.write_ok, rep.write_error, rep.fresh_members,
                [(m.machine_id, m.fresh, m.age_seconds, bool(m.error)) for m in rep.members],
                sorted(os.listdir(d)))

    ref, port = both(run)
    assert port == ref and port[2] == 2 and "ancient-peer" not in port[4]


def test_nfs_group_unwritable_dir(tmp_path):
    (tmp_path / "file").write_text("")

    def run(pkg):
        cfg = pkg.nfs.GroupConfig(dir=str(tmp_path / "file" / "sub"))
        rep = pkg.nfs.NFSChecker("me", [cfg]).check_group(cfg)
        return rep.write_ok, rep.write_error, rep.members

    ref, port = both(run)
    assert port == ref and port[0] is False and port[1]


# -- procfs, against psutil on this host ---------------------------------------------------

def test_procfs_against_psutil():
    psutil = pytest.importorskip("psutil")
    assert procfs.cpu_count() == psutil.cpu_count(logical=True)
    vm, ref = procfs.virtual_memory(), psutil.virtual_memory()
    assert vm.total == ref.total
    assert abs(vm.available - ref.available) < 256 << 20 and abs(vm.percent - ref.percent) < 1.0
    assert vm.used == vm.total - vm.available
    assert [tuple(p) for p in procfs.disk_partitions()] == \
        [(p.device, p.mountpoint, p.fstype, p.opts) for p in psutil.disk_partitions()]
    assert [tuple(p)[:3] for p in procfs.disk_partitions(all=True)] == \
        [(p.device, p.mountpoint, p.fstype) for p in psutil.disk_partitions(all=True)]
    du, ref = procfs.disk_usage("/"), psutil.disk_usage("/")
    assert du.total == ref.total and abs(du.used - ref.used) < 256 << 20
    assert abs(du.percent - ref.percent) < 1.0
    ticks = procfs.cpu_times()
    times = psutil.cpu_times()
    hz = os.sysconf("SC_CLK_TCK")
    assert abs(ticks[3] / hz - times.idle) < 10.0 * os.cpu_count()


STAT = "cpu  {} 0 {} {} {} 0 0 0 {} 0\ncpu0 1 2 3 4\n"


@pytest.mark.parametrize("before, after, want", [
    ((100, 50, 1000, 10, 0), (200, 100, 1100, 10, 0), 60.0),
    ((100, 50, 1000, 10, 0), (100, 50, 1000, 10, 0), 0.0),
    ((100, 50, 1000, 10, 0), (150, 50, 1000, 60, 0), 50.0),
    ((100, 50, 1000, 10, 40), (200, 50, 1100, 10, 90), 50.0),
    ((500, 50, 1000, 10, 0), (100, 50, 1100, 10, 0), 0.0),
], ids=["busy", "idle-clock", "iowait-is-idle", "guest-in-user", "counter-went-back"])
def test_procfs_cpu_usage_is_psutils_formula(tmp_path, before, after, want):
    stat = tmp_path / "stat"
    stat.write_text(STAT.format(*before))
    usage = procfs.CPUUsage(str(stat))
    stat.write_text(STAT.format(*after))
    assert usage.percent() == want


@pytest.mark.parametrize("meminfo, want", [
    ("MemTotal: 1000 kB\nMemFree: 100 kB\nMemAvailable: 600 kB\n", (1024000, 614400, 40.0)),
    ("MemTotal: 1000 kB\nMemFree: 100 kB\nMemAvailable: 0 kB\nCached: 300 kB\n",
     (1024000, 409600, 60.0)),
    ("MemTotal: 1000 kB\nMemFree: 100 kB\nMemAvailable: 5000 kB\n", (1024000, 102400, 90.0)),
], ids=["available", "no-available", "available-above-total"])
def test_procfs_meminfo(tmp_path, meminfo, want):
    (tmp_path / "meminfo").write_text(meminfo)
    vm = procfs.virtual_memory(str(tmp_path / "meminfo"))
    assert (vm.total, vm.available, vm.percent) == want


def test_procfs_partitions_from_fixtures(tmp_path):
    (tmp_path / "filesystems").write_text("nodev\tsysfs\nnodev\tproc\n\text4\n\txfs\nnodev\tzfs\n")
    (tmp_path / "mounts").write_text(
        "/dev/sda1 / ext4 rw 0 0\nproc /proc proc rw 0 0\nnone /x ext4 rw 0 0\n"
        "tank /tank zfs rw 0 0\n/dev/sdb /mnt/my\\040disk xfs ro 0 0\n")
    kw = dict(mounts_path=str(tmp_path / "mounts"),
              filesystems_path=str(tmp_path / "filesystems"))
    assert [p.mountpoint for p in procfs.disk_partitions(**kw)] == ["/", "/tank", "/mnt/my disk"]
    assert len(procfs.disk_partitions(all=True, **kw)) == 5


def test_procfs_missing_cpu_line(tmp_path):
    (tmp_path / "stat").write_text("intr 0\n")
    with pytest.raises(ValueError):
        procfs.cpu_times(str(tmp_path / "stat"))


# -- host ----------------------------------------------------------------------------------

def test_host_strings_match_the_reference():
    assert p_host.kernel_version() == r_host.kernel_version() != ""
    assert p_host.os_name() == r_host.os_name() != ""


def run_results(*results):
    """A ``run_command`` stub that answers ``results`` in turn and records argv."""
    calls = []

    def run(argv, timeout=None, env=None):
        calls.append((list(argv), timeout))
        rc, out, err = results[min(len(calls), len(results)) - 1]
        return SimpleNamespace(exit_code=rc, output=out, error=err)

    return run, calls


@pytest.mark.parametrize("detect_virt, product", [
    ((0, "kvm\n", ""), "whatever"),
    ((1, "none\n", ""), "Google Compute Engine"),
    ((1, "", ""), "PowerEdge XE9680"),
    ((-1, "", "No such file or directory"), ""),
    ((1, "none\n", ""), ""),
], ids=["systemd-kvm", "dmi-google", "dmi-product", "no-binary", "bare-metal"])
def test_virtualization(monkeypatch, detect_virt, product):
    got = []
    for pkg in PKGS:
        run, calls = run_results(detect_virt)
        monkeypatch.setattr(pkg.host, "run_command", run)
        monkeypatch.setattr(pkg.host, "_read_first_line", lambda p: product)
        got.append((pkg.host.virtualization(), calls))
    assert got[1] == got[0]


@pytest.mark.parametrize("use_systemctl, results", [
    (True, [(0, "", "")]),
    (True, [(1, "nope", "denied")]),
    (False, [(1, "", ""), (0, "", "")]),
    (True, [(1, "", ""), (1, "out", ""), (1, "", "")]),
])
def test_reboot_and_stop(monkeypatch, use_systemctl, results):
    got = []
    for pkg in PKGS:
        run, calls = run_results(*results)
        monkeypatch.setattr(pkg.host, "run_command", run)
        got.append((pkg.host.reboot(use_systemctl=use_systemctl), pkg.host.reboot(dry_run=True),
                    pkg.host.stop_daemon_systemd(), pkg.host.stop_daemon_systemd("x.service"),
                    calls))
    assert got[1] == got[0]


# -- process ----------------------------------------------------------------------------------

def recorded_run(monkeypatch):
    """``subprocess.run`` stubbed: records each call and the script a call
    runs, answers with exit 0 and the argv as output."""
    calls = []

    def run(argv, **kw):
        script = open(argv[1]).read() if argv[0] == "bash" and os.path.isfile(argv[1]) else None
        mode = os.stat(argv[1]).st_mode & 0o777 if script is not None else None
        calls.append((argv[0], argv[1] if script is None else "<script>", script, mode,
                      kw["timeout"], kw["stdout"], kw["stderr"], kw["check"],
                      kw["env"].get("TPUD_X")))
        return subprocess.CompletedProcess(argv, 0, stdout=" ".join(argv[:1]).encode())

    monkeypatch.setattr(subprocess, "run", run)
    return calls


@pytest.mark.parametrize("call", [
    lambda m: m.run_shell("echo out; echo err 1>&2; exit 3"),
    lambda m: m.run_shell("true", timeout=0.2, env={"TPUD_X": "1"}),
    lambda m: m.run_bash_script("x=5\ny=7\necho $((x+y))\n"),
    lambda m: m.run_bash_script("exit 1", timeout=3.0, env={"TPUD_X": "2"}),
    lambda m: m.ExclusiveRunner().run_script("p1", "echo one"),
], ids=["shell", "shell-env", "script", "script-env", "exclusive"])
def test_runners_make_the_references_call(monkeypatch, call):
    calls = recorded_run(monkeypatch)
    ref, port = call(r_process), call(p_process)
    strip = lambda r: {**dataclasses.asdict(r), "duration_seconds": 0.0}  # noqa: E731
    assert strip(port) == strip(ref)
    assert calls[1] == calls[0] and len(calls) == 2


def test_script_file_is_removed_and_private(monkeypatch, tmp_path):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    calls = recorded_run(monkeypatch)
    p_process.run_bash_script("echo hi")
    assert calls[0][3] == 0o700 and list(tmp_path.iterdir()) == []


def test_runner_timeout_and_spawn_failure(monkeypatch):
    def timeout(argv, **kw):
        raise subprocess.TimeoutExpired(argv, kw["timeout"], output=b"partial")

    def missing(argv, **kw):
        raise FileNotFoundError(2, "No such file or directory", argv[0])

    for fake in (timeout, missing):
        monkeypatch.setattr(subprocess, "run", fake)
        for call in (lambda m: m.run_shell("sleep 5", timeout=0.2),
                     lambda m: m.run_bash_script("sleep 5", timeout=0.2)):
            strip = lambda r: {**dataclasses.asdict(r), "duration_seconds": 0.0}  # noqa: E731
            assert strip(call(p_process)) == strip(call(r_process))


def test_exclusive_runner_records_and_serializes(monkeypatch):
    recorded_run(monkeypatch)
    runner = p_process.ExclusiveRunner()
    assert runner.run_script("p1", "echo one").ok and "p1" in runner.last_run
    assert runner._mu.acquire(blocking=False)  # not held after a run
    runner._mu.release()


@pytest.mark.parametrize("command", ['a "b c" d', "nsenter -t 1 -m -- systemctl is-active x",
                                     "x 'y z'\\ w", ""])
def test_split_command(command):
    assert p_process.split_command(command) == r_process.split_command(command)


def test_process_defaults_are_the_references():
    assert p_process.DEFAULT_TIMEOUT == r_process.DEFAULT_TIMEOUT


# -- inotify edges (tests/test_inotify_host_edges.py) --------------------------------------------

@pytest.fixture
def watches(tmp_path):
    f = tmp_path / "watched"
    f.write_text("")
    ws = [InotifyWatch.create(str(f)), RefInotifyWatch.create(str(f))]
    yield f, ws
    for w in ws:
        if w is not None:
            w.close()


def test_inotify_fires_on_modify_and_coalesces(watches):
    f, ws = watches
    if ws[1] is None:
        assert ws[0] is None
        return
    assert [w.wait(0) for w in ws] == [False, False]
    with open(f, "a") as fh:
        for _ in range(100):
            fh.write("x")
            fh.flush()
    assert [w.wait(1000) for w in ws] == [True, True]
    assert [w.wait(0) for w in ws] == [False, False]  # drained, no storm


def test_inotify_close_is_idempotent_and_a_closed_watch_stays_quiet(watches):
    f, ws = watches
    if ws[1] is None:
        return
    for w in ws:
        w.close()
        w.close()
    with open(f, "a") as fh:
        fh.write("y")
    assert [w.wait(1) for w in ws] == [False, False]


def test_inotify_missing_path(tmp_path):
    assert InotifyWatch.create(str(tmp_path / "nope")) is None
    assert RefInotifyWatch.create(str(tmp_path / "nope")) is None
