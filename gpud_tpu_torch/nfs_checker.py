"""Group NFS health checker.

Reference: pkg/nfs-checker/checker.go:15-60 — every machine in a group
writes ``<dir>/<machineID>`` with a freshness payload, then reads and
validates its peers' files; stale files past the TTL are cleaned up. This
is the only peer-to-peer observation channel in the daemon (SURVEY §2.8):
peers see each other through the shared filesystem, no network protocol.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GroupConfig:
    """Reference: group_config.go / member_config.go."""

    dir: str = ""
    ttl_seconds: float = 300.0
    expected_members: int = 0   # 0 = whoever shows up

    def validate(self) -> Optional[str]:
        if not self.dir:
            return "nfs group dir required"
        if self.ttl_seconds < 10:
            return "ttl must be >= 10s"
        return None


@dataclass
class MemberReport:
    machine_id: str
    fresh: bool
    age_seconds: float
    error: str = ""


@dataclass
class GroupReport:
    group_dir: str
    write_ok: bool = False
    write_error: str = ""
    members: List[MemberReport] = field(default_factory=list)

    @property
    def fresh_members(self) -> int:
        return sum(1 for m in self.members if m.fresh)


class NFSChecker:
    def __init__(self, machine_id: str, configs: List[GroupConfig]) -> None:
        self.machine_id = machine_id
        self.configs = configs
        self.time_now_fn = time.time

    def check_group(self, cfg: GroupConfig) -> GroupReport:
        rep = GroupReport(group_dir=cfg.dir)
        now = self.time_now_fn()
        my_file = os.path.join(cfg.dir, self.machine_id)

        # 1. write our own freshness file
        try:
            os.makedirs(cfg.dir, exist_ok=True)
            payload = json.dumps({"machine_id": self.machine_id, "ts": now})
            tmp = my_file + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(payload)
            os.replace(tmp, my_file)
            # read-back validation (reference: write then read/validate)
            with open(my_file, "r", encoding="utf-8") as f:
                back = json.loads(f.read())
            rep.write_ok = back.get("machine_id") == self.machine_id
            if not rep.write_ok:
                rep.write_error = "read-back mismatch"
        except OSError as e:
            rep.write_error = str(e)
            return rep

        # 2. read peers + TTL cleanup
        try:
            names = os.listdir(cfg.dir)
        except OSError as e:
            rep.write_error = rep.write_error or str(e)
            return rep
        for name in sorted(names):
            if name.endswith(".tmp"):
                continue
            path = os.path.join(cfg.dir, name)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    d = json.loads(f.read())
                age = now - float(d.get("ts", 0))
                fresh = age <= cfg.ttl_seconds
                rep.members.append(
                    MemberReport(machine_id=name, fresh=fresh, age_seconds=age)
                )
                if not fresh and name != self.machine_id and age > 3 * cfg.ttl_seconds:
                    # stale cleanup (reference: TTL cleanup)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            except (OSError, ValueError) as e:
                rep.members.append(
                    MemberReport(
                        machine_id=name, fresh=False, age_seconds=-1, error=str(e)
                    )
                )
        return rep

    def check_all(self) -> Dict[str, GroupReport]:
        return {cfg.dir: self.check_group(cfg) for cfg in self.configs}
