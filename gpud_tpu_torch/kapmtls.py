"""Node-local mTLS credential manager; the port of ``gpud_tpu/kapmtls.py``
(``cryptography`` is imported only where a certificate is parsed).

Reference: pkg/kapmtls/manager.go:29-50 — installs short-lived client
certificates pushed by the control plane into atomic release directories
with a ``current`` symlink, supports activation, readiness probing and
rollback, so the node-local agent's identity can be rotated without
downtime.

Layout::

    <root>/releases/<version>/{client.crt,client.key}
    <root>/current -> releases/<version>

Consumer contract (how an agent must read the credentials): resolve
``current`` ONCE, open the resolved directory, and read both files
through that directory handle (``openat``-style). Two independent path
opens through the symlink can straddle a rotation and pair a cert with
the wrong key. Re-pushes of the ACTIVE version swap the release
directory's content with ``renameat2(RENAME_EXCHANGE)`` where the kernel
supports it, so a held directory handle keeps serving the complete OLD
pair for its lifetime — a dirfd consumer never observes a torn pair.
Vacated release dirs are garbage-collected only after GC_GRACE_SECONDS
so an in-flight load through a just-replaced handle still completes.
On filesystems WITHOUT RENAME_EXCHANGE the re-push falls back to a
move-aside dance; there a loader can transiently hit ENOENT and must
retry once (tests/test_kapmtls_agent.py models the dirfd consumer).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import List, Optional

from gpud_tpu_torch.log import audit, get_logger

logger = get_logger(__name__)

DEFAULT_ROOT = "/var/lib/tpud/kapmtls"

_RENAME_EXCHANGE = 2  # linux/fs.h
_AT_FDCWD = -100


def _exchange_dirs(a: str, b: str) -> bool:
    """Atomically swap two paths via renameat2(RENAME_EXCHANGE); False
    when the kernel/filesystem doesn't support it (caller falls back to
    the move-aside dance)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ret = libc.renameat2(
            _AT_FDCWD, os.fsencode(a), _AT_FDCWD, os.fsencode(b),
            _RENAME_EXCHANGE,
        )
        return ret == 0
    except (OSError, AttributeError):
        return False


@dataclass
class Status:
    current_version: str = ""
    versions: List[str] = None
    ready: bool = False
    error: str = ""

    def to_dict(self) -> dict:
        return {
            "current_version": self.current_version,
            "versions": list(self.versions or []),
            "ready": self.ready,
            "error": self.error,
        }


# vacated release dirs (.old-*/.tmp-*) survive this long so in-flight
# dirfd loads complete; collected at the next install
GC_GRACE_SECONDS = 60.0

# strict staging suffix: <version>.(tmp|old)-<usec-stamp>
_STAGING_RE = re.compile(r"\.(?:tmp|old)-(\d+)$")


class CertManager:
    def __init__(self, root: str = DEFAULT_ROOT) -> None:
        self.root = root
        self.releases_dir = os.path.join(root, "releases")
        self.gc_grace_seconds = GC_GRACE_SECONDS

    @staticmethod
    def _staging_stamp(name: str) -> Optional[float]:
        """Unix time (seconds) a staging/old dir was created, parsed from
        its `<version>.(tmp|old)-<usec>` suffix — mtime is useless here
        (rename preserves the ORIGINAL install mtime, which would make a
        just-vacated dir look ancient and defeat the grace period)."""
        m = _STAGING_RE.search(name)
        if m is None:
            return None
        return int(m.group(1)) / 1e6

    def _gc_stale_dirs(self, grace: Optional[float] = None) -> None:
        """Collect vacated staging/old dirs older than the grace period."""
        if grace is None:
            grace = self.gc_grace_seconds
        try:
            entries = os.listdir(self.releases_dir)
        except OSError:
            return
        now = time.time()
        for e in entries:
            stamp = self._staging_stamp(e)
            if stamp is None:
                continue  # not a staging dir (strict suffix match)
            if now - stamp >= grace:
                shutil.rmtree(
                    os.path.join(self.releases_dir, e), ignore_errors=True
                )

    def _release_dir(self, version: str) -> str:
        if not version or "/" in version or version.startswith("."):
            raise ValueError(f"invalid version {version!r}")
        if ".tmp-" in version or ".old-" in version:
            # the same substring filter status() uses to hide staging
            # dirs: anything installable must be visible in status() and
            # never GC-eligible — reject the whole namespace up front
            raise ValueError(f"version {version!r} uses the staging-dir namespace")
        return os.path.join(self.releases_dir, version)

    # -- install -----------------------------------------------------------
    def install(self, version: str, cert_pem: str, key_pem: str) -> Optional[str]:
        """Write a release atomically (tmp dir + rename). Returns error or
        None. Does NOT activate (reference: install then Activate)."""
        try:
            d = self._release_dir(version)
        except ValueError as e:
            return str(e)
        self._gc_stale_dirs()
        tmp = d + f".tmp-{int(time.time() * 1e6)}"
        try:
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "client.crt"), "w", encoding="utf-8") as f:
                f.write(cert_pem)
            key_path = os.path.join(tmp, "client.key")
            with open(key_path, "w", encoding="utf-8") as f:
                f.write(key_pem)
            os.chmod(key_path, 0o600)
            old = None
            active_repush = False
            if os.path.isdir(d):
                # re-push of an existing version. Preferred path: atomic
                # content swap — `current` never moves, and a consumer
                # holding the directory open keeps the complete old pair
                # (see the consumer contract in the module docstring)
                if _exchange_dirs(tmp, d):
                    # tmp now holds the OLD release; park it for deferred
                    # GC — deleting immediately would unlink files under
                    # a consumer that resolved just before the exchange
                    try:
                        os.rename(tmp, d + f".old-{int(time.time() * 1e6)}")
                    except OSError:
                        # parking failed: leave it — the .tmp- name is
                        # already GC-eligible after the grace period, and
                        # deleting now is the unlink-under-a-consumer
                        # this whole path exists to avoid
                        pass
                    audit("kapmtls_install", version=version)
                    return None
                # fallback (no RENAME_EXCHANGE): move the old dir aside so
                # the version path is free for the new release
                old = d + f".old-{int(time.time() * 1e6)}"
                link = os.path.join(self.root, "current")
                try:
                    active_repush = os.path.realpath(link) == os.path.realpath(d)
                except OSError:
                    active_repush = False
                if active_repush:
                    # pivot `current` onto the fully-written tmp dir BEFORE
                    # vacating the version path: every crash point below
                    # except the final rename→retarget gap (two syscalls)
                    # leaves `current` pointing at existing credentials
                    self._retarget_current(os.path.relpath(tmp, self.root))
                try:
                    os.rename(d, old)
                except OSError:
                    if active_repush:
                        self._retarget_current(os.path.join("releases", version))
                    raise
            try:
                os.rename(tmp, d)
            except OSError:
                if old is not None:
                    os.rename(old, d)  # restore the previous release
                if active_repush:
                    self._retarget_current(os.path.join("releases", version))
                raise
            if active_repush:
                self._retarget_current(os.path.join("releases", version))
            # `old` (if any) is left for deferred GC — same in-flight
            # consumer rationale as the exchange path
        except OSError as e:
            return str(e)
        audit("kapmtls_install", version=version)
        return None

    def _retarget_current(self, target: str) -> None:
        """Atomic symlink replace of ``current`` → *target* (relative to
        root); cleans up the staging link on failure."""
        link = os.path.join(self.root, "current")
        tmp_link = link + f".tmp-{int(time.time() * 1e6)}"
        try:
            os.symlink(target, tmp_link)
            os.replace(tmp_link, link)
        except OSError:
            try:
                os.unlink(tmp_link)
            except OSError:
                pass
            raise

    # -- activate / rollback ----------------------------------------------
    def activate(self, version: str) -> Optional[str]:
        """Atomic ``current`` symlink swap (symlink-at-temp-path + rename,
        reference: atomic release dirs + current symlink)."""
        try:
            d = self._release_dir(version)
        except ValueError as e:
            return str(e)  # same error-string contract as install()
        if not os.path.isdir(d):
            return f"release {version!r} not installed"
        if not self._release_ready(d):
            return f"release {version!r} failed readiness probe"
        try:
            self._retarget_current(os.path.join("releases", version))
        except OSError as e:
            return str(e)
        audit("kapmtls_activate", version=version)
        return None

    @staticmethod
    def _version_key(v: str):
        """Natural ordering so v10 > v9 (lexicographic would invert them)."""
        return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", v)]

    def rollback(self) -> Optional[str]:
        """Activate the newest release strictly older than current — a
        newer-but-inactive release must never be "rolled back" to."""
        st = self.status()
        if not st.current_version:
            return "nothing active to roll back from"
        cur_key = self._version_key(st.current_version)
        older = [v for v in st.versions if self._version_key(v) < cur_key]
        if not older:
            return "no older release to roll back to"
        target = sorted(older, key=self._version_key)[-1]
        err = self.activate(target)
        if err is None:
            audit("kapmtls_rollback", to=target)
        return err

    # -- status ------------------------------------------------------------
    @staticmethod
    def _release_ready(d: str) -> bool:
        """Readiness: both files exist, key is private, cert parses."""
        crt = os.path.join(d, "client.crt")
        key = os.path.join(d, "client.key")
        if not (os.path.isfile(crt) and os.path.isfile(key)):
            return False
        try:
            from cryptography import x509

            with open(crt, "rb") as f:
                x509.load_pem_x509_certificate(f.read())
            return True
        except Exception:  # noqa: BLE001
            return False

    def status(self) -> Status:
        versions: List[str] = []
        if os.path.isdir(self.releases_dir):
            versions = sorted(
                v for v in os.listdir(self.releases_dir)
                if os.path.isdir(os.path.join(self.releases_dir, v))
                and ".tmp-" not in v and ".old-" not in v
            )
        current = ""
        link = os.path.join(self.root, "current")
        try:
            current = os.path.basename(os.readlink(link))
        except OSError:
            pass
        ready = bool(current) and self._release_ready(os.path.join(self.root, "current"))
        return Status(current_version=current, versions=versions, ready=ready)
