"""Subprocess/script runner (the port of ``gpud_tpu/process.py``).

Reference: pkg/process/process.go:21-431 (Process with Start/Wait/combined
output) and pkg/process/runner.go:14-21 + runner_exclusive.go
(Runner/ExclusiveRunner for serialized bash-script execution — plugins must
never run concurrently with each other).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

DEFAULT_TIMEOUT = 60.0


@dataclass
class RunResult:
    exit_code: int = 0
    output: str = ""         # combined stdout+stderr (reference semantics)
    error: str = ""          # runner-level error (timeout, spawn failure)
    duration_seconds: float = 0.0
    timed_out: bool = False

    @property
    def ok(self) -> bool:
        return self.exit_code == 0 and not self.error


def run_command(
    argv: List[str],
    timeout: float = DEFAULT_TIMEOUT,
    env: Optional[Dict[str, str]] = None,
) -> RunResult:
    """Run an argv command, returning combined output (never raises)."""
    t0 = time.monotonic()
    try:
        cp = subprocess.run(
            argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            timeout=timeout,
            env={**os.environ, **(env or {})},
            check=False,
        )
        return RunResult(
            exit_code=cp.returncode,
            output=cp.stdout.decode("utf-8", "replace"),
            duration_seconds=time.monotonic() - t0,
        )
    except subprocess.TimeoutExpired as e:
        out = (e.output or b"").decode("utf-8", "replace") if e.output else ""
        return RunResult(
            exit_code=-1,
            output=out,
            error=f"timed out after {timeout}s",
            duration_seconds=time.monotonic() - t0,
            timed_out=True,
        )
    except (OSError, ValueError) as e:
        return RunResult(
            exit_code=-1,
            error=str(e),
            duration_seconds=time.monotonic() - t0,
        )


def run_shell(
    command: str,
    timeout: float = DEFAULT_TIMEOUT,
    env: Optional[Dict[str, str]] = None,
) -> RunResult:
    """Run a shell command string (for nsenter-style overrides where the
    whole command line is configured, reference: components/registry.go:46-64)."""
    return run_command(["bash", "-c", command], timeout=timeout, env=env)


def run_bash_script(
    script: str,
    timeout: float = DEFAULT_TIMEOUT,
    env: Optional[Dict[str, str]] = None,
) -> RunResult:
    """Write a multi-line bash script to a temp file and execute it — the
    custom-plugin step contract (reference: pkg/custom-plugins/types.go:108-130)."""
    with tempfile.NamedTemporaryFile(
        "w", suffix=".sh", prefix="tpud-", delete=False
    ) as f:
        f.write(script)
        path = f.name
    try:
        os.chmod(path, 0o700)
        return run_command(["bash", path], timeout=timeout, env=env)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def split_command(command: str) -> List[str]:
    return shlex.split(command)


class ExclusiveRunner:
    """Serializes script execution across plugin components
    (reference: pkg/process/runner_exclusive.go)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.last_run: Dict[str, float] = {}

    def run_script(
        self,
        name: str,
        script: str,
        timeout: float = DEFAULT_TIMEOUT,
        env: Optional[Dict[str, str]] = None,
    ) -> RunResult:
        with self._mu:
            self.last_run[name] = time.time()
            return run_bash_script(script, timeout=timeout, env=env)
