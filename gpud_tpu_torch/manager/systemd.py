"""systemd unit management for tpud; the port of
``gpud_tpu/manager/systemd.py``, whose unit runs ``python -m
gpud_tpu_torch run``.

Reference: pkg/gpud-manager/systemd/gpud.service:1-37 (Type=notify,
Restart=always, EnvironmentFile) + pkg/systemd helpers. tpud runs as a
python module; Restart=always also covers the self-update and
plugin-change restart-by-exit-code paths (update.py EXIT_CODE_UPDATE,
dispatch.py RESTART_EXIT_CODE). Every ``systemctl`` call goes through
the module's ``run_command`` and every file through the paths given, so
a test replaces the one and points the others into a temp dir.
"""

from __future__ import annotations

import os
from typing import Optional

from gpud_tpu_torch.process import run_command

UNIT_NAME = "tpud.service"
UNIT_PATH = f"/etc/systemd/system/{UNIT_NAME}"
ENV_FILE = "/etc/default/tpud"

UNIT_TEMPLATE = """[Unit]
Description=tpud — GPU fleet health monitoring daemon
Wants=network-online.target
After=network-online.target

[Service]
Type=notify
NotifyAccess=main
EnvironmentFile=-{env_file}
ExecStart={python} -m gpud_tpu_torch run $TPUD_FLAGS
Restart=always
RestartSec=5
# self-update and plugin changes restart via dedicated exit codes
SuccessExitStatus=244 245
StandardOutput=append:/var/log/tpud.log
StandardError=append:/var/log/tpud.log

[Install]
WantedBy=multi-user.target
"""


def render_unit(python: str = "", env_file: str = ENV_FILE) -> str:
    import sys

    return UNIT_TEMPLATE.format(python=python or sys.executable, env_file=env_file)


def install_unit(flags: str = "", unit_path: str = UNIT_PATH,
                 env_file: str = ENV_FILE) -> Optional[str]:
    """Write unit + env file, daemon-reload, enable+start. Returns error
    string or None (reference: gpud up systemd path, SURVEY §3.5)."""
    try:
        os.makedirs(os.path.dirname(unit_path), exist_ok=True)
        with open(unit_path, "w", encoding="utf-8") as f:
            f.write(render_unit(env_file=env_file))
        with open(env_file, "w", encoding="utf-8") as f:
            f.write(f'TPUD_FLAGS="{flags}"\n')
    except OSError as e:
        return f"cannot write unit files: {e}"
    for argv in (
        ["systemctl", "daemon-reload"],
        ["systemctl", "enable", UNIT_NAME],
        ["systemctl", "restart", UNIT_NAME],
    ):
        r = run_command(argv, timeout=60)
        if r.exit_code != 0:
            return f"{' '.join(argv)} failed: {r.error or r.output.strip()}"
    return None


def uninstall_unit(unit_path: str = UNIT_PATH) -> Optional[str]:
    errs = []
    for argv in (
        ["systemctl", "stop", UNIT_NAME],
        ["systemctl", "disable", UNIT_NAME],
    ):
        r = run_command(argv, timeout=60)
        if r.exit_code != 0:
            errs.append(f"{' '.join(argv)}: {r.error or r.output.strip()}")
    try:
        if os.path.exists(unit_path):
            os.unlink(unit_path)
    except OSError as e:
        errs.append(str(e))
    run_command(["systemctl", "daemon-reload"], timeout=60)
    return "; ".join(errs) if errs else None


def is_active(unit: str = UNIT_NAME) -> bool:
    return run_command(["systemctl", "is-active", unit], timeout=10).exit_code == 0
