"""Built-in self-update install pipeline; the port of
``gpud_tpu/update_install.py``.

Reference: pkg/update/update.go:19-50 — the reference downloads the release
tarball from pkg.gpud.dev, verifies it, and swaps the running executable
in-process, so a pushed target version works on a stock node with no
operator-side tooling. This module is that pipeline for the Python build:

  download  {base}/tpud-{version}.tar.gz  (+ .tar.gz.sig)
  verify    ed25519 via gpud_tpu_torch/release/distsign.py — either a locally
            pinned signing key, or a pinned ROOT key + a downloaded
            signing key endorsed by it ({base}/signing.pub + .rootsig)
  install   extract into a staging dir, atomic rename into
            <install_dir>/versions/<version>, atomic `current` symlink swap
  restart   the caller (VersionFileWatcher) exits 244 so systemd / the
            DaemonSet restarts into the new version

`TPUD_UPDATE_HOOK` remains an operator override for bespoke installs
(gpud_tpu_torch/update.py); when unset and a base URL + trust anchor are
configured, this pipeline runs instead.

The daemon imports this module whenever the update watcher is on; the
download (``urllib.request``, which loads ``ssl``), extraction
(``tarfile``) and staging (``tempfile``) modules load when a pipeline runs.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Callable, Optional

from gpud_tpu_torch.log import audit, get_logger
from gpud_tpu_torch.release import distsign

logger = get_logger(__name__)

ENV_BASE_URL = "TPUD_UPDATE_BASE_URL"
ENV_SIGNING_PUB = "TPUD_UPDATE_SIGNING_PUB"
ENV_ROOT_PUB = "TPUD_UPDATE_ROOT_PUB"
ENV_INSTALL_DIR = "TPUD_UPDATE_INSTALL_DIR"

# package-name contract on the distribution server
PACKAGE_FMT = "tpud-{version}.tar.gz"
SIGNING_PUB_NAME = "signing.pub"

DOWNLOAD_TIMEOUT = 120.0
# target versions ride into download URLs and filesystem paths: whitelist
# instead of blacklisting — `?`/`#`/whitespace would alter URL semantics
VERSION_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")
MAX_PACKAGE_BYTES = 1 << 30  # 1 GiB hard cap on any downloaded artifact
CURRENT_LINK = "current"
VERSIONS_DIR = "versions"


def _download(url: str, dest: str, max_bytes: int = MAX_PACKAGE_BYTES) -> Optional[str]:
    """Fetch ``url`` into ``dest``. Returns an error string or None."""
    import urllib.error
    import urllib.request

    try:
        req = urllib.request.Request(url, headers={"User-Agent": "tpud-update"})
        with urllib.request.urlopen(req, timeout=DOWNLOAD_TIMEOUT) as resp:  # noqa: S310
            with open(dest, "wb") as f:
                total = 0
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    total += len(chunk)
                    if total > max_bytes:
                        return f"artifact exceeds {max_bytes} bytes: {url}"
                    f.write(chunk)
        return None
    except (urllib.error.URLError, OSError, ValueError) as e:
        return f"download failed: {url}: {e}"


def _safe_extract(tar_path: str, dest_dir: str) -> Optional[str]:
    """Extract a tarball refusing path traversal, absolute names, links
    escaping the tree, and device/FIFO members."""
    import tarfile

    dest_real = os.path.realpath(dest_dir)
    try:
        with tarfile.open(tar_path, "r:gz") as tf:
            for m in tf.getmembers():
                name = m.name
                target = os.path.realpath(os.path.join(dest_real, name))
                if target != dest_real and not target.startswith(dest_real + os.sep):
                    return f"unsafe member path in package: {name!r}"
                if m.issym() or m.islnk():
                    link_target = os.path.realpath(
                        os.path.join(os.path.dirname(target), m.linkname)
                    )
                    if not link_target.startswith(dest_real + os.sep):
                        return f"unsafe link in package: {name!r} -> {m.linkname!r}"
                elif not (m.isreg() or m.isdir()):
                    return f"unsupported member type in package: {name!r}"
            # Python 3.10.0–3.10.11 predate the filter= parameter and raise
            # TypeError on it; the member validation above already enforces
            # the safety properties, so plain extract is equivalent there
            use_filter = True
            for m in tf.getmembers():
                if use_filter:
                    try:
                        tf.extract(m, dest_real, set_attrs=True, filter="data")
                        continue
                    except TypeError:
                        use_filter = False
                tf.extract(m, dest_real, set_attrs=True)
        return None
    except (tarfile.TarError, OSError) as e:
        return f"package extraction failed: {e}"


def resolve_signing_pub(
    base_url: str,
    workdir: str,
    signing_pub: str = "",
    root_pub: str = "",
) -> tuple[str, Optional[str]]:
    """Resolve the signing public key to verify the package with.

    Either a pinned signing key path is given directly, or a pinned ROOT
    key verifies a downloaded signing key (the reference's distsign chain:
    root keys stay offline, signing keys rotate with releases).
    Returns (signing_pub_path, error).
    """
    if signing_pub:
        if not os.path.isfile(signing_pub):
            return "", f"signing public key not found: {signing_pub}"
        return signing_pub, None
    if not root_pub:
        return "", "no trust anchor: set a signing or root public key"
    if not os.path.isfile(root_pub):
        return "", f"root public key not found: {root_pub}"
    pub_path = os.path.join(workdir, SIGNING_PUB_NAME)
    sig_path = pub_path + ".rootsig"
    for url, dest in (
        (f"{base_url}/{SIGNING_PUB_NAME}", pub_path),
        (f"{base_url}/{SIGNING_PUB_NAME}.rootsig", sig_path),
    ):
        err = _download(url, dest)
        if err:
            return "", err
    try:
        endorsed = distsign.verify_key(root_pub, pub_path, sig_path)
    except (ValueError, RuntimeError, OSError) as e:
        # malformed PEM / missing cryptography package must surface as the
        # documented error-string contract, not a traceback up the watcher
        return "", f"signing key verification failed: {e}"
    if not endorsed:
        return "", "downloaded signing key is not endorsed by the pinned root key"
    return pub_path, None


def install_tree(extracted_dir: str, install_dir: str, version: str) -> Optional[str]:
    """Atomically install an extracted tree as ``versions/<version>`` and
    swap the ``current`` symlink (the executable-swap step of
    update.go:19-50, done dir-wise for a package distribution)."""
    versions = os.path.join(install_dir, VERSIONS_DIR)
    os.makedirs(versions, exist_ok=True)
    final = os.path.join(versions, version)
    staging = final + f".staging-{os.getpid()}"
    aside = final + f".old-{os.getpid()}"
    moved_aside = False
    try:
        if os.path.exists(staging):
            shutil.rmtree(staging)
        shutil.move(extracted_dir, staging)
        if os.path.exists(final):
            # reinstall of an already-installed version: move the live tree
            # aside instead of deleting it, so a failure between here and
            # the rename below can roll back — `current` must point at a
            # live tree on every path out of this function
            if os.path.exists(aside):
                shutil.rmtree(aside)
            os.rename(final, aside)
            moved_aside = True
        try:
            os.rename(staging, final)
        except OSError:
            if moved_aside:
                try:
                    os.rename(aside, final)
                    moved_aside = False
                except OSError:
                    # leave the aside tree on disk for manual recovery —
                    # the cleanup below must not delete the only survivor
                    moved_aside = False
                    logger.exception(
                        "rollback of %s failed; previous tree left at %s",
                        final, aside,
                    )
            raise
        # atomic symlink swap: build aside, replace over
        link = os.path.join(install_dir, CURRENT_LINK)
        tmp_link = link + f".tmp-{os.getpid()}"
        if os.path.lexists(tmp_link):
            os.unlink(tmp_link)
        os.symlink(os.path.join(VERSIONS_DIR, version), tmp_link)
        os.replace(tmp_link, link)
        return None
    except OSError as e:
        return f"install failed: {e}"
    finally:
        if os.path.exists(staging):
            shutil.rmtree(staging, ignore_errors=True)
        if moved_aside and os.path.exists(aside):
            shutil.rmtree(aside, ignore_errors=True)


def perform_update(
    target_version: str,
    base_url: str = "",
    install_dir: str = "",
    signing_pub: str = "",
    root_pub: str = "",
) -> Optional[str]:
    """Download → verify → install ``target_version``. Returns an error
    string (daemon stays on the current version) or None on success (the
    caller restart-exits). Every failure path leaves the installed tree
    and `current` symlink untouched."""
    base_url = (base_url or os.environ.get(ENV_BASE_URL, "")).rstrip("/")
    install_dir = install_dir or os.environ.get(ENV_INSTALL_DIR, "")
    signing_pub = signing_pub or os.environ.get(ENV_SIGNING_PUB, "")
    root_pub = root_pub or os.environ.get(ENV_ROOT_PUB, "")
    if not base_url:
        return "no package base URL configured"
    if not install_dir:
        return "no install dir configured"
    if not target_version or not VERSION_RE.match(target_version):
        return f"invalid target version {target_version!r}"

    import tempfile

    workdir = tempfile.mkdtemp(prefix="tpud-update-")
    try:
        pub_path, err = resolve_signing_pub(base_url, workdir, signing_pub, root_pub)
        if err:
            return err
        pkg_name = PACKAGE_FMT.format(version=target_version)
        pkg_path = os.path.join(workdir, pkg_name)
        sig_path = pkg_path + ".sig"
        for url, dest in (
            (f"{base_url}/{pkg_name}", pkg_path),
            (f"{base_url}/{pkg_name}.sig", sig_path),
        ):
            err = _download(url, dest)
            if err:
                return err
        try:
            err = distsign.verify_package(pub_path, pkg_path, sig_path)
        except (ValueError, RuntimeError, OSError) as e:
            # a corrupt/hostile PEM or an env without the cryptography
            # package raises; keep the Optional[str] error contract
            err = str(e)
        if err:
            audit("self_update_verify_failed", target=target_version, error=err)
            return f"package signature rejected: {err}"
        extracted = os.path.join(workdir, "extracted")
        os.makedirs(extracted)
        err = _safe_extract(pkg_path, extracted)
        if err:
            audit("self_update_extract_failed", target=target_version, error=err)
            return err
        err = install_tree(extracted, install_dir, target_version)
        if err:
            return err
        audit("self_update_installed", target=target_version, install_dir=install_dir)
        logger.warning("installed %s into %s", target_version, install_dir)
        return None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def installer_from_env() -> Optional[Callable[[str], Optional[str]]]:
    """Build the watcher's installer callable from the environment; None
    when the pipeline is not configured (the watcher then warns-and-stays,
    preserving the crash-loop guard)."""
    base_url = os.environ.get(ENV_BASE_URL, "")
    install_dir = os.environ.get(ENV_INSTALL_DIR, "")
    if not base_url or not install_dir:
        return None
    return lambda target: perform_update(target)
