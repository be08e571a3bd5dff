"""The port's login (gpud_tpu_torch/login.py, its POST on the standard
library's ``http.client``) and node-local mTLS credential manager
(gpud_tpu_torch/kapmtls.py) against gpud_tpu's.

The reference's own tests — tests/test_login_edges.py,
test_kapmtls_agent.py and test_kapmtls_fallback.py — run on the port's
modules (tests/torch_ref_tests.py). Then both packages log in to the stdlib
plane on 127.0.0.1 (the reference through ``requests``): the plane receives
the same request, except the accelerator in the machine info, and both
persist the same identity; and both credential managers, fed the same
pushes, keep the same releases."""

import os

import pytest

pytest.importorskip("cryptography")

import gpud_tpu.blockdev as ref_blockdev  # noqa: E402
import gpud_tpu.host as ref_host  # noqa: E402
import gpud_tpu.kapmtls as ref_kapmtls  # noqa: E402
import gpud_tpu.login as ref_login  # noqa: E402
import gpud_tpu.metadata as ref_md  # noqa: E402
import gpud_tpu.sqlite as ref_sqlite  # noqa: E402
import gpud_tpu_torch.blockdev as port_blockdev  # noqa: E402
import gpud_tpu_torch.host as port_host  # noqa: E402
import gpud_tpu_torch.kapmtls as port_kapmtls  # noqa: E402
import gpud_tpu_torch.login as port_login  # noqa: E402
import gpud_tpu_torch.metadata as port_md  # noqa: E402
import gpud_tpu_torch.sqlite as port_sqlite  # noqa: E402
from gpud_tpu_torch import procfs  # noqa: E402

from tests.helpers import keypair  # noqa: E402
from torch_loopback_plane import LoopbackPlane  # noqa: E402
from torch_ref_tests import port_tests  # noqa: E402

globals().update(port_tests("test_login_edges.py"))
globals().update(port_tests("test_kapmtls_agent.py"))
globals().update(port_tests("test_kapmtls_fallback.py"))

PKGS = {"ref": (ref_login, ref_md, ref_sqlite), "port": (port_login, port_md, port_sqlite)}
KEYS = ("machine_id", "token", "machine_proof", "endpoint", "node_labels", "public_ip",
        "private_ip")


@pytest.fixture()
def still_host(monkeypatch):
    """Uptime and file-system usage read once, for both packages."""
    import psutil

    up = ref_host.uptime_seconds()
    monkeypatch.setattr(ref_host, "uptime_seconds", lambda: up)
    monkeypatch.setattr(port_host, "uptime_seconds", lambda: up)
    seen, read = {}, psutil.disk_usage

    def usage(path):
        return seen.setdefault(path, read(path))

    monkeypatch.setattr(psutil, "disk_usage", usage)
    monkeypatch.setattr(procfs, "disk_usage", usage)
    used = {}
    for mod in (ref_blockdev, port_blockdev):
        read_used = mod._statvfs_used
        monkeypatch.setattr(mod, "_statvfs_used",
                            lambda path, read_used=read_used: used.setdefault(path, read_used(path)))


def test_login_over_http_is_the_reference_s(tmp_path, still_host):
    got = {}
    for name, (login, md, sqlite) in PKGS.items():
        plane = LoopbackPlane().start()
        db = sqlite.DB(str(tmp_path / f"{name}.db"))
        try:
            meta = md.Metadata(db)
            meta.set(md.KEY_MACHINE_ID, "local-id")
            resp = login.login(plane.endpoint + "/", "join-tok", meta, node_labels={"pool": "a"},
                               provider="p", region="r", public_ip="1.2.3.4",
                               private_ip="10.0.0.1")
            body = dict(plane.logins[0])
            body["machine_info"] = {k: v for k, v in body["machine_info"].items()
                                    if k not in ("gpu_info", "tpu_info")}
            stored = {k: meta.get(getattr(md, "KEY_" + k.upper())) for k in KEYS}
            got[name] = (resp.to_dict(), body, stored)
        finally:
            db.close()
            plane.stop()
    ref, port = got["ref"], got["port"]
    assert port[0] == ref[0] and port[1] == ref[1]
    assert {k: v for k, v in port[2].items() if k != "endpoint"} == \
        {k: v for k, v in ref[2].items() if k != "endpoint"}
    assert port[2]["endpoint"].startswith("http://127.0.0.1:")
    assert port[1]["machine_id"] == port[2]["machine_id"] == "local-id"
    assert (port[2]["token"], port[2]["machine_proof"]) == ("cp-session-token", "cp-proof")


def test_a_refused_login_raises_as_requests_does(tmp_path):
    """A non-2xx answer raises; ``requests`` raises its HTTPError, the port
    its ``HTTPStatusError``, both ``OSError``s with the same message."""
    errs = []
    for name, (login, md, sqlite) in PKGS.items():
        plane = LoopbackPlane().start()
        db = sqlite.DB(":memory:")
        try:
            with pytest.raises(OSError) as e:
                login.login(plane.endpoint + "/nowhere", "t", md.Metadata(db))
            errs.append(str(e.value).replace(str(plane.port), "PORT"))
            assert md.Metadata(db).get(md.KEY_TOKEN) in ("", None)
        finally:
            db.close()
            plane.stop()
    assert errs[0] == errs[1] == (
        "404 Client Error: Not Found for url: http://127.0.0.1:PORT/nowhere/api/v1/login")


def test_credential_managers_keep_the_same_releases(tmp_path):
    pushes = [("v1", "A"), ("v2", "B"), ("v1", "A2"), ("../x", "C"), ("v3", "D")]
    pems = {m: keypair(m) for _, m in pushes}
    got = {}
    for name, mod in (("ref", ref_kapmtls), ("port", port_kapmtls)):
        mgr = mod.CertManager(root=str(tmp_path / name))
        log = []
        for version, marker in pushes:
            cert, key = pems[marker]
            log.append(mgr.install(version, cert, key))
            log.append(mgr.activate(version))
        log.append(mgr.rollback())
        st = mgr.status()
        cur = os.path.join(mgr.root, "current")
        got[name] = (log, st.to_dict(), open(os.path.join(cur, "client.crt")).read())
    assert got["port"] == got["ref"]
    assert got["port"][1]["current_version"] == "v2"

