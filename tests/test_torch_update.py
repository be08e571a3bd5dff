"""The port's update path (gpud_tpu_torch/update.py, update_install.py,
release/distsign.py and the CLI's ``release`` and ``update``) against
gpud_tpu's.

First the reference's own tests of these modules — tests/test_update_edges.py,
test_update_install_fixes.py, test_update_pipeline.py,
test_distsign_tampering.py and test_release_cli.py — run on the port's
modules (tests/torch_ref_tests.py). Then both packages side by side on the
same artifacts: the same installs, the same refusals with the same error
strings, signatures of one package verified by the other, and the faults
``ADVICE.md`` names (``update_install.py:92``, ``:146``, ``:182``, ``:200``,
``update.py:105``) held in both: each is repaired in the reference's
current code, and the port behaves as it does (ROADMAP C7)."""

import io
import os
import sys
import tarfile

import numpy as np
import pytest

pytest.importorskip("cryptography")

import gpud_tpu.release.distsign as ref_distsign  # noqa: E402
import gpud_tpu.update as ref_update  # noqa: E402
import gpud_tpu.update_install as ref_ui  # noqa: E402
import gpud_tpu_torch.release.distsign as port_distsign  # noqa: E402
import gpud_tpu_torch.update as port_update  # noqa: E402
import gpud_tpu_torch.update_install as port_ui  # noqa: E402

from torch_loopback_plane import LoopbackPlane  # noqa: E402
from torch_ref_tests import port_tests  # noqa: E402

globals().update(port_tests("test_update_edges.py"))
globals().update(port_tests("test_update_install_fixes.py"))
globals().update(port_tests("test_update_pipeline.py"))
globals().update(port_tests("test_distsign_tampering.py"))
globals().update(port_tests("test_release_cli.py"))

PKGS = {"ref": (ref_ui, ref_distsign, ref_update), "port": (port_ui, port_distsign, port_update)}
SEED = 5


def tarball(path, files):
    with tarfile.open(path, "w:gz") as tf:
        for name, content in files.items():
            data = content.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.fixture()
def release(tmp_path):
    """Keys, a root-endorsed signing key and two signed packages (one built
    from a numpy seed), served on 127.0.0.1."""
    rng = np.random.default_rng(SEED)
    keys = tmp_path / "keys"
    root_key, root_pub = port_distsign.write_keypair(str(keys), "root")
    sign_key, sign_pub = port_distsign.write_keypair(str(keys), "signing")
    port_distsign.sign_key(root_key, sign_pub)
    files = {}
    for version in ("1.0.0", "2.0.0"):
        blob = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 4096))
        pkg = tarball(tmp_path / f"tpud-{version}.tar.gz",
                      {"bin/tpud": f"#!/bin/sh\necho {version}\n", "VERSION": version,
                       "data/blob": blob})
        port_distsign.sign_package(sign_key, pkg)
        files[f"tpud-{version}.tar.gz"] = open(pkg, "rb").read()
        files[f"tpud-{version}.tar.gz.sig"] = open(pkg + ".sig", "rb").read()
    files["signing.pub"] = open(sign_pub, "rb").read()
    files["signing.pub.rootsig"] = open(sign_pub + ".rootsig", "rb").read()
    plane = LoopbackPlane().start()
    plane.files = files
    yield plane, root_pub, sign_pub
    plane.stop()


def tree(root):
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out, os.readlink(os.path.join(root, "current"))


def test_installs_and_upgrades_as_the_reference(release, tmp_path):
    plane, root_pub, _ = release
    got = {}
    for name, (ui, _ds, _up) in PKGS.items():
        root = tmp_path / name
        errs = [ui.perform_update(v, base_url=plane.endpoint, install_dir=str(root),
                                  root_pub=root_pub) for v in ("1.0.0", "2.0.0", "1.0.0")]
        got[name] = (errs, tree(root))
    assert got["port"] == got["ref"]
    assert got["port"][0] == [None, None, None] and got["port"][1][1] == "versions/1.0.0"


@pytest.mark.parametrize("case", ["tampered", "missing", "bad-version", "unendorsed",
                                  "garbage-pin", "no-anchor"])
def test_refusals_are_the_reference_s(release, tmp_path, case):
    plane, root_pub, sign_pub = release
    version, kw = "1.0.0", {"root_pub": root_pub}
    if case == "tampered":
        plane.files["tpud-1.0.0.tar.gz"] += b"\0"
    elif case == "missing":
        version = "3.0.0"
    elif case == "bad-version":
        version = "1.0?x"
    elif case == "unendorsed":
        plane.files["signing.pub.rootsig"] = b"\0" * 64
    elif case == "garbage-pin":
        # ADVICE :200: a malformed PEM as the pinned key answers an error
        # string, as the documented contract says
        bad = tmp_path / "garbage.pub"
        bad.write_text("-----BEGIN PUBLIC KEY-----\nnot base64\n-----END PUBLIC KEY-----\n")
        kw = {"signing_pub": str(bad)}
    elif case == "no-anchor":
        kw = {}
    got = {}
    for name, (ui, _ds, _up) in PKGS.items():
        root = tmp_path / name
        got[name] = (ui.perform_update(version, base_url=plane.endpoint, install_dir=str(root),
                                       **kw), os.path.exists(root / "current"))
    assert got["port"] == got["ref"]
    assert got["port"][0] and not got["port"][1]


def test_a_failed_swap_keeps_the_installed_tree_in_both(tmp_path, monkeypatch):
    """ADVICE :146: a reinstall whose final rename fails keeps the tree that
    was installed (the reference's code moves it aside first, as the port's
    does)."""
    got = {}
    for name, (ui, _ds, _up) in PKGS.items():
        inst = tmp_path / name / "install"
        first = tmp_path / name / "a"
        first.mkdir(parents=True)
        (first / "VERSION").write_text("one")
        assert ui.install_tree(str(first), str(inst), "1.0") is None
        second = tmp_path / name / "b"
        second.mkdir()
        (second / "VERSION").write_text("two")
        real = os.rename

        def failing(src, dst, real=real):
            if src.endswith(f".staging-{os.getpid()}"):
                raise OSError("simulated rename failure")
            return real(src, dst)

        monkeypatch.setattr(ui.os, "rename", failing)
        err = ui.install_tree(str(second), str(inst), "1.0")
        monkeypatch.setattr(ui.os, "rename", real)
        got[name] = (err, (inst / "versions" / "1.0" / "VERSION").read_text(),
                     sorted(os.listdir(inst / "versions")), os.readlink(inst / "current"))
    assert got["port"] == got["ref"]
    assert got["port"][1:] == ("one", ["1.0"], "versions/1.0")


def test_a_failing_target_backs_off_in_both(tmp_path):
    """update.py:105: a target whose install keeps failing backs off,
    doubling, instead of being downloaded again every poll."""
    got = {}
    for name, (_ui, _ds, up) in PKGS.items():
        attempts, clock = [], {"now": 1000.0}
        w = up.VersionFileWatcher(str(tmp_path / f"{name}.target"), current_version="1.0.0",
                                  installer=lambda t: (attempts.append(t), "boom")[1],
                                  interval=3600)
        w._now = lambda: clock["now"]
        up.write_target_version(w.path, "2.0.0")
        seen = []
        for dt in (0, 10, 299, 2, 400, 600, 1):
            clock["now"] += dt
            seen.append((w.check_once(), len(attempts), w._backoff))
        got[name] = seen
    assert got["port"] == got["ref"]


def test_signatures_verify_across_the_packages(tmp_path):
    pkg = tarball(tmp_path / "p.tar.gz", {"x": "y"})
    for signer, verifier in ((port_distsign, ref_distsign), (ref_distsign, port_distsign)):
        d = tmp_path / signer.__name__
        root_key, root_pub = signer.write_keypair(str(d), "root")
        sign_key, sign_pub = signer.write_keypair(str(d), "signing")
        signer.sign_key(root_key, sign_pub)
        sig = signer.sign_package(sign_key, pkg, str(d / "p.sig"))
        assert verifier.verify_package(sign_pub, pkg, sig_path=sig, root_pub_path=root_pub,
                                       key_sig_path=sign_pub + ".rootsig") is None
        assert verifier.verify_key(root_pub, sign_pub, sign_pub + ".rootsig")
        assert not verifier.verify_key(sign_pub, sign_pub, sign_pub + ".rootsig")


def test_without_cryptography_both_give_the_reference_s_error(tmp_path, monkeypatch):
    # the reference imports the package at module load, inside a try; the
    # port on each call
    monkeypatch.setattr(ref_distsign, "serialization", None)
    for name in [m for m in sys.modules if m == "cryptography" or m.startswith("cryptography.")]:
        monkeypatch.setitem(sys.modules, name, None)
    errs = []
    for ds in (ref_distsign, port_distsign):
        with pytest.raises(RuntimeError) as e:
            ds.generate_keypair()
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "the 'cryptography' package is required for release signing"


def test_importing_the_update_path_loads_no_network_or_crypto_module():
    import subprocess
    import textwrap

    code = textwrap.dedent("""
        import json, sys
        before = set(sys.modules)
        import gpud_tpu_torch.update, gpud_tpu_torch.update_install
        import gpud_tpu_torch.release.distsign
        print(json.dumps(sorted(m for m in set(sys.modules) - before if m.split(".")[0] in (
            "cryptography", "urllib", "ssl", "_ssl", "http", "email", "tarfile", "hashlib"))))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
