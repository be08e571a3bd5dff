"""Subprocess runner (the part of ``gpud_tpu/process.py`` the port needs).

Reference: pkg/process/process.go:21-431 (Process with Start/Wait/combined
output). The runtime component probes systemd units through
``run_command``; the plugin runners come with the device-free daemon.
"""

from __future__ import annotations

import os
import subprocess
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
