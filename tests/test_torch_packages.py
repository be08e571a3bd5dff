"""The port's package manager (gpud_tpu_torch/manager/packages.py, with
``InotifyWatch.add_path`` and its ``mask``) against gpud_tpu's.

The reference's own tests of the package manager, the update watcher, login
and the NFS checker — tests/test_manager_update_login.py — run on the
port's modules (tests/torch_ref_tests.py); its cloud-provider cases are
left out: tests/test_torch_host_adapters.py holds them, and the port's
detector would reach the metadata services were a fake not to take.
Then both packages side by side over the same package trees, drawn from a
numpy seed: the same installs, skips, dependency waits, deletes and
statuses, pass by pass."""

import os
import stat

import numpy as np
import pytest

from gpud_tpu.inotify import InotifyWatch as RefWatch
from gpud_tpu.manager import packages as ref_packages

from gpud_tpu_torch.inotify import InotifyWatch as PortWatch
from gpud_tpu_torch.manager import packages as port_packages

from torch_ref_tests import port_tests

SEED = 17

globals().update(port_tests("test_manager_update_login.py", exclude=[
    "test_detect_gcp_with_fake_imds", "test_detect_gcp_absent",
    "test_detect_oci_with_fake_imds", "test_detect_metadata_mount"]))


def script(path, body):
    path.write_text("#!/bin/bash\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def package_tree(root, seed):
    """Packages with installers that pass or fail, targets, dependencies,
    skip probes, status probes and delete markers."""
    rng = np.random.default_rng(seed)
    names = [f"pkg{i}" for i in range(6)]
    for i, name in enumerate(names):
        d = root / name
        d.mkdir(parents=True)
        version = f"{int(rng.integers(1, 9))}.{int(rng.integers(0, 9))}"
        (d / "version").write_text(version)
        code = 1 if i == 2 else 0
        script(d / "init.sh", f'echo "$TARGET_VERSION" > "$(dirname "$0")/installed_version"\n'
                              f"exit {code}\n" if code == 0 else f"exit {code}\n")
        if i == 1:
            (d / "requires").write_text("pkg0\n")
        if i == 3:
            (d / "requires").write_text("pkg9\n")  # never present: waits
        if i == 4:
            script(d / "should_skip.sh", "exit 0\n")
        if i == 5:
            script(d / "status.sh", "exit 0\n")
    return names


def passes(mod, root):
    pm = mod.PackageManager(str(root))
    out = []
    for n in range(3):
        if n == 2:
            (root / "pkg0" / "delete").write_text("")
        pm.reconcile_once()
        out.append([s.to_dict() for s in pm.status(probe=True)])
    return out, sorted(os.listdir(root))


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_reconcile_passes_are_the_reference_s(tmp_path, seed):
    package_tree(tmp_path / "ref", seed)
    package_tree(tmp_path / "port", seed)
    assert passes(port_packages, tmp_path / "port") == passes(ref_packages, tmp_path / "ref")


def test_the_informer_watches_added_paths_as_the_reference(tmp_path):
    got = []
    for W in (RefWatch, PortWatch):
        root = tmp_path / W.__module__
        (root / "a").mkdir(parents=True)
        w = W.create(str(root), mask=W.TREE_MASK)
        if w is None:
            pytest.skip("inotify unavailable")
        try:
            added = (w.add_path(str(root / "a")), w.add_path(str(root / "missing")))
            (root / "a" / "version").write_text("1")
            got.append((added, w.wait(2000), W.TREE_MASK,
                        W.IN_MODIFY))
        finally:
            w.close()
        assert not w.add_path(str(root / "a"))  # closed
    assert got[0] == got[1] and got[1][0] == (True, False)
