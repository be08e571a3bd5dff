"""Self-update via the target-version file; the port of
``gpud_tpu/update.py``.

Reference: pkg/update — ``UpdateTargetVersion`` watches a version file
(version_file.go:16, polled every 30s at pkg/server/server.go:814-832);
when the target differs from the running version the daemon exits with a
dedicated code so systemd/DaemonSet restarts it into the new binary. The
binary-download path (update.go:19-50, pkg.gpud.dev tarballs + ed25519
verification) is the built-in pipeline in gpud_tpu_torch/update_install.py
(download → distsign verify → atomic install); ``TPUD_UPDATE_HOOK``
remains an operator override for bespoke installs.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from gpud_tpu_torch.log import audit, get_logger
from gpud_tpu_torch.version import __version__

logger = get_logger(__name__)

POLL_INTERVAL = 30.0   # reference: server.go:814-832
EXIT_CODE_UPDATE = 244 # supervisor restarts into the new version
# failed-target backoff: a target that keeps failing to install must not be
# re-downloaded (and re-fail-logged) every 30s poll — back off exponentially
# until the target file changes or the backoff window lapses
BACKOFF_INITIAL = 300.0
BACKOFF_MAX = 4 * 3600.0
# script invoked with TARGET_VERSION env to install the new version before
# the restart-exit (the reference's tarball-download step, update.go:19-50)
ENV_UPDATE_HOOK = "TPUD_UPDATE_HOOK"


def read_target_version(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        return ""


def write_target_version(path: str, version: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(version + "\n")
    os.replace(tmp, path)
    audit("set_target_version", version=version)


class VersionFileWatcher:
    def __init__(
        self,
        path: str,
        current_version: str = __version__,
        on_update: Optional[Callable[[str], None]] = None,
        interval: float = POLL_INTERVAL,
        installer: Optional[Callable[[str], Optional[str]]] = None,
    ) -> None:
        self.path = path
        self.current_version = current_version
        self.on_update = on_update or self._default_on_update
        # built-in install pipeline (update_install.perform_update); when
        # None and no hook is set the watcher warns-and-stays
        if installer is None:
            from gpud_tpu_torch.update_install import installer_from_env

            installer = installer_from_env()
        self.installer = installer
        self._exit: Callable[[int], None] = os._exit  # injectable for tests
        # env override so lifecycle e2e tests don't wait the 30s cadence;
        # clamped (a zero would busy-spin the loop) and logged so it can't
        # silently shadow an explicit interval in production
        self.interval = interval
        env_interval = os.environ.get("TPUD_UPDATE_POLL_SECONDS", "")
        if env_interval:
            try:
                self.interval = max(0.25, float(env_interval))
                logger.info(
                    "update watcher poll interval overridden to %.2fs "
                    "(TPUD_UPDATE_POLL_SECONDS)", self.interval,
                )
            except ValueError:
                pass
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job = None  # scheduler Job when scheduler-driven
        # failed-target memo: (target, failed_at, current_backoff)
        import time as _time

        self._now = _time.time  # injectable for tests
        self._failed_target = ""
        self._failed_at = 0.0
        self._backoff = 0.0

    def _default_on_update(self, target: str) -> None:
        """Install (hook override, else the built-in pipeline), then
        restart-exit. On install failure — or with nothing configured —
        we must NOT exit: the restarted process would still be the old
        version and see the same mismatch — a permanent 30-second crash
        loop on every node the update was pushed to."""
        hook = os.environ.get(ENV_UPDATE_HOOK, "")
        if hook:
            from gpud_tpu_torch.process import run_command

            r = run_command(
                ["bash", hook], timeout=15 * 60.0, env={"TARGET_VERSION": target}
            )
            if r.exit_code != 0:
                logger.error(
                    "update hook failed (exit %d): %s", r.exit_code, r.output[-500:]
                )
                self._note_failure(target)
                return
            logger.warning("update hook installed %s", target)
        elif self.installer is not None:
            err = self.installer(target)
            if err:
                logger.error(
                    "built-in update to %s failed: %s; staying on %s",
                    target, err, self.current_version,
                )
                self._note_failure(target)
                return
        else:
            if not getattr(self, "_warned_no_hook", False):
                logger.warning(
                    "target version %s != running %s but no update hook or "
                    "built-in pipeline is configured; staying on the "
                    "current version",
                    target, self.current_version,
                )
                self._warned_no_hook = True
            return
        logger.warning(
            "installed %s; exiting %d for supervisor restart",
            target, EXIT_CODE_UPDATE,
        )
        audit("self_update_exit", target=target, current=self.current_version)
        self._exit(EXIT_CODE_UPDATE)  # noqa: SLF001 — immediate, like the reference

    def _note_failure(self, target: str) -> None:
        """Record a failed install so ``check_once`` backs off this target
        (doubling per consecutive failure) instead of re-downloading it
        every poll. A different target resets the memo."""
        if target == self._failed_target and self._backoff:
            self._backoff = min(self._backoff * 2, BACKOFF_MAX)
        else:
            self._failed_target = target
            self._backoff = BACKOFF_INITIAL
        self._failed_at = self._now()
        logger.warning(
            "update to %s failed; next attempt in %.0fs unless the target "
            "changes", target, self._backoff,
        )

    def check_once(self) -> bool:
        """Returns True if an update was triggered."""
        target = read_target_version(self.path)
        if not target or target == self.current_version:
            return False
        if (
            target == self._failed_target
            and self._now() - self._failed_at < self._backoff
        ):
            return False  # persistently failing target: in backoff
        self.on_update(target)
        return True

    def start(self, scheduler=None) -> None:
        if scheduler is not None:
            if self._job is None and self._thread is None:
                self._job = scheduler.add_job(
                    "update-watcher",
                    self._scheduled_check,
                    interval=self.interval,
                    initial_delay=self.interval,
                )
            return
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="tpud-update-watcher", daemon=True
        )
        self._thread.start()

    def _scheduled_check(self) -> None:
        # the legacy loop exits once an update is triggered (the daemon is
        # about to restart-exec); the job equivalent is self-cancellation
        if self.check_once() and self._job is not None:
            self._job.cancel()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                if self.check_once():
                    return
            except Exception:  # noqa: BLE001
                logger.exception("update check failed")

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
