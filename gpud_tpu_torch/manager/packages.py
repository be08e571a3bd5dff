"""The package manager: control-plane-pushed add-on packages; the port
of ``gpud_tpu/manager/packages.py``.

Reference: pkg/gpud-manager — a file informer watches
``<dataDir>/packages/*/init.sh`` dirs (informer/file_informer.go:22-34) and
a PackageController runs reconcile/update/install/status/delete loops
(controllers/package_controller.go:46-52). Status is reported as
``PackageStatus{IsInstalled, Installing, Progress, Target/CurrentVersion}``
(packages/packages.go:13-35).

Contract per package dir ``<packages>/<name>/``:
- ``init.sh``      — installer; receives TARGET_VERSION env; writes
                     ``installed_version`` on success.
- ``version``      — target version (pushed by the control plane).
- ``status.sh``    — optional health probe; exit 0 = running.
- ``delete``       — deletion marker (pushed by the control plane); the
                     delete loop runs ``uninstall.sh`` (if present) and
                     removes the package dir (reference: deleteRunner,
                     package_controller.go:274-294 — there the package's
                     script answers needDelete; our contract is file-
                     marker-driven like ``version``).
- ``uninstall.sh`` — optional cleanup hook run before dir removal.
- ``requires``     — optional dependency list (one package name per
                     line); install waits until every dependency is
                     installed (reference: Dependency gating,
                     package_controller.go installRunner).
- ``should_skip.sh`` — optional probe; exit 0 marks the package skipped
                     (already provided by the image/host) without
                     installing (reference: shouldSkip contract).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import PackagePhase, PackageStatus
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.process import run_command

logger = get_logger(__name__)

# reference reconciles at 3s with an fsnotify informer; the no-op pass
# here is a handful of stat()s, so a 15s poll keeps pushes responsive
# without a watcher thread (footprint discipline, SURVEY §7)
RECONCILE_INTERVAL = 15.0
INSTALL_TIMEOUT = 15 * 60.0


def _read(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        return ""


class PackageManager:
    """Reference: gpudmanager.Manager Start/Status (manager.go:24-46);
    the five controller loops are collapsed into one reconcile thread."""

    def __init__(self, packages_dir: str) -> None:
        self.packages_dir = packages_dir
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self._progress: Dict[str, int] = {}
        self._installing: Dict[str, bool] = {}
        self._skipped: set = set()  # should_skip.sh said the host provides it
        # probe results cached on (target version, probe mtime): a skipped
        # package would otherwise fork its probe every reconcile forever
        self._skip_cache: Dict[str, tuple] = {}
        self._dep_warned: set = set()  # (pkg, dep) pairs already logged

    # -- discovery ---------------------------------------------------------
    def package_names(self) -> List[str]:
        if not os.path.isdir(self.packages_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.packages_dir)):
            d = os.path.join(self.packages_dir, name)
            if os.path.isdir(d) and os.path.isfile(os.path.join(d, "init.sh")):
                out.append(name)
        return out

    # -- status ------------------------------------------------------------
    def status(self, probe: bool = True) -> List[PackageStatus]:
        """``probe=False`` skips status.sh subprocesses for callers on
        latency-sensitive paths (the session serve loop)."""
        out = []
        for name in self.package_names():
            d = os.path.join(self.packages_dir, name)
            target = _read(os.path.join(d, "version"))
            current = _read(os.path.join(d, "installed_version"))
            with self._mu:
                installing = self._installing.get(name, False)
                progress = self._progress.get(name, 0)
                host_provided = name in self._skipped
            if installing:
                phase = PackagePhase.INSTALLING
            elif host_provided:
                phase = PackagePhase.SKIPPED
            elif current and (not target or current == target):
                phase = PackagePhase.INSTALLED
            elif not target:
                phase = PackagePhase.SKIPPED
            else:
                phase = PackagePhase.UNKNOWN
            out.append(
                PackageStatus(
                    name=name,
                    phase=phase,
                    status="running" if (probe and self._probe(d)) else "",
                    current_version=current,
                    target_version=target,
                    progress=100 if phase == PackagePhase.INSTALLED else progress,
                    is_installed=phase == PackagePhase.INSTALLED,
                    installing=installing,
                )
            )
        return out

    def _probe(self, pkg_dir: str) -> bool:
        probe = os.path.join(pkg_dir, "status.sh")
        if not os.path.isfile(probe):
            return False
        return run_command(["bash", probe], timeout=30.0).exit_code == 0

    # -- reconcile ---------------------------------------------------------
    def reconcile_once(self) -> None:
        # delete pass scans ALL subdirs, not just installable ones — a
        # partial push without init.sh must still honor its delete marker
        if os.path.isdir(self.packages_dir):
            for name in sorted(os.listdir(self.packages_dir)):
                d = os.path.join(self.packages_dir, name)
                if os.path.isdir(d) and os.path.exists(os.path.join(d, "delete")):
                    self._delete(name, d)
        names = self.package_names()
        for name in names:
            d = os.path.join(self.packages_dir, name)
            target = _read(os.path.join(d, "version"))
            current = _read(os.path.join(d, "installed_version"))
            if not target or target == current:
                continue
            if self._should_skip(name, d):
                continue
            if not self._deps_ready(name, d, names):
                continue
            self._install(name, d, target)

    def _should_skip(self, name: str, pkg_dir: str) -> bool:
        """Optional should_skip.sh probe: exit 0 ⇒ the host already
        provides this package; mark skipped, never install (reference:
        shouldSkip, package_controller.go installRunner). The result is
        cached on (target version, probe mtime) so a skipped package does
        not fork its probe on every reconcile pass."""
        probe = os.path.join(pkg_dir, "should_skip.sh")
        if not os.path.isfile(probe):
            with self._mu:
                self._skipped.discard(name)
                self._skip_cache.pop(name, None)
            return False
        target = _read(os.path.join(pkg_dir, "version"))
        try:
            mtime = os.stat(probe).st_mtime_ns
        except OSError:
            mtime = 0
        key = (target, mtime)
        with self._mu:
            cached = self._skip_cache.get(name)
        if cached is not None and cached[0] == key:
            return cached[1]
        skip = run_command(["bash", probe], timeout=60.0).exit_code == 0
        with self._mu:
            self._skip_cache[name] = (key, skip)
            if skip:
                self._skipped.add(name)
            else:
                self._skipped.discard(name)
        return skip

    def _dep_satisfied(self, dep: str) -> bool:
        """Installed, or host-provided per its should_skip probe."""
        with self._mu:
            if dep in self._skipped:
                return True
        return bool(
            _read(os.path.join(self.packages_dir, dep, "installed_version"))
        )

    def _deps_ready(self, name: str, pkg_dir: str, known: List[str]) -> bool:
        """Optional requires file: every listed package must be installed
        (or host-provided/skipped) first (reference: Dependency gating).
        Gating is logged once per (package, dependency) pair; the warning
        re-arms when the dependency later satisfies, so a regression logs
        again rather than silently re-gating."""
        req = _read(os.path.join(pkg_dir, "requires"))
        if not req:
            return True
        for dep in (ln.strip() for ln in req.splitlines()):
            if not dep or dep.startswith("#"):
                continue
            if dep == name:
                continue  # self-dependency would deadlock
            if dep in known and self._dep_satisfied(dep):
                with self._mu:
                    self._dep_warned.discard((name, dep))
                continue
            why = "unknown package" if dep not in known else "not installed yet"
            with self._mu:
                first = (name, dep) not in self._dep_warned
                self._dep_warned.add((name, dep))
            if first:
                logger.warning(
                    "package %s waiting on dependency %s (%s)", name, dep, why
                )
            return False
        return True

    def _delete(self, name: str, pkg_dir: str) -> None:
        """Reference: deleteRunner (package_controller.go:274-294) — run
        the package's cleanup hook, then drop the package entirely."""
        with self._mu:
            if self._installing.get(name):
                return  # let the in-flight install finish first
            self._installing[name] = True
        logger.info("deleting package %s", name)
        try:
            hook = os.path.join(pkg_dir, "uninstall.sh")
            # run the hook at most once even when dir removal fails and the
            # delete retries every reconcile — uninstall hooks are often
            # non-idempotent (stop a service, deregister, ...). The "done"
            # signal is removing the hook script itself: unlike a marker
            # file inside the dir, a partially-failed rmtree can only move
            # this in the safe direction (hook gone → never re-run).
            if os.path.isfile(hook):
                r = run_command(
                    ["bash", hook], timeout=INSTALL_TIMEOUT,
                    env={"PACKAGE_DIR": pkg_dir},
                )
                if r.exit_code != 0:
                    logger.warning(
                        "package %s uninstall hook failed (exit %d): %s — "
                        "removing anyway", name, r.exit_code, r.output[-500:],
                    )
                try:
                    os.unlink(hook)
                except OSError:
                    pass
            import shutil

            try:
                shutil.rmtree(pkg_dir)
                logger.info("package %s deleted", name)
            except OSError as e:
                # marker survives → retried next reconcile (hook skipped)
                logger.warning(
                    "package %s dir removal failed (%s); will retry", name, e
                )
        finally:
            with self._mu:
                self._installing.pop(name, None)
                self._progress.pop(name, None)
                # a delete-then-repush of the same name must not inherit
                # stale skip/dep state
                self._skipped.discard(name)
                self._skip_cache.pop(name, None)
                self._dep_warned = {
                    pair for pair in self._dep_warned if pair[0] != name
                }

    def _install(self, name: str, pkg_dir: str, target: str) -> None:
        with self._mu:
            if self._installing.get(name):
                return
            self._installing[name] = True
            self._progress[name] = 10
        logger.info("installing package %s version %s", name, target)
        try:
            r = run_command(
                ["bash", os.path.join(pkg_dir, "init.sh")],
                timeout=INSTALL_TIMEOUT,
                env={"TARGET_VERSION": target, "PACKAGE_DIR": pkg_dir},
            )
            if r.exit_code == 0:
                with open(
                    os.path.join(pkg_dir, "installed_version"), "w", encoding="utf-8"
                ) as f:
                    f.write(target)
                logger.info("package %s installed at %s", name, target)
            else:
                logger.warning(
                    "package %s install failed (exit %d): %s",
                    name, r.exit_code, r.output[-500:],
                )
        finally:
            with self._mu:
                self._installing[name] = False
                self._progress[name] = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="tpud-package-manager", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        """File-informer loop (reference: informer/file_informer.go uses
        fsnotify): inotify on the packages tree reconciles a push within
        ~0.5s; the RECONCILE_INTERVAL poll remains as the fallback
        heartbeat (and the only mechanism where inotify is unavailable)."""
        import time as _time

        from gpud_tpu_torch.inotify import InotifyWatch

        try:
            os.makedirs(self.packages_dir, exist_ok=True)
        except OSError:
            pass
        informer = InotifyWatch.create(
            self.packages_dir, mask=InotifyWatch.TREE_MASK
        )
        if informer is None:
            # no inotify (non-Linux/sandbox): plain interval polling, one
            # blocking wait per cycle (footprint discipline)
            while not self._stop.wait(RECONCILE_INTERVAL):
                try:
                    self.reconcile_once()
                except Exception:  # noqa: BLE001
                    logger.exception("package reconcile failed")
            return
        watched: set = set()
        last = 0.0
        while not self._stop.is_set():
            try:
                # watch each package subdir so version/delete pushes INSIDE
                # them wake the loop too; prune vanished dirs so a
                # delete-then-repush of the same name is re-watched
                watched = {d for d in watched if os.path.isdir(d)}
                new_watch = False
                for name in self.package_names():
                    d = os.path.join(self.packages_dir, name)
                    if d not in watched and informer.add_path(d):
                        watched.add(d)
                        new_watch = True
                # a just-watched dir may have received writes BEFORE its
                # watch existed (push races dir creation) — reconcile now
                # rather than waiting for an event that already happened
                woke = True if new_watch else informer.wait(500)
                now = _time.monotonic()
                if woke or now - last >= RECONCILE_INTERVAL:
                    self.reconcile_once()
                    last = now
            except Exception:  # noqa: BLE001 — the loop must outlive any
                logger.exception("package informer cycle failed")
                if self._stop.wait(1.0):
                    break
        informer.close()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
