"""Custom-plugin specs — YAML-defined dynamic components.

Reference: pkg/custom-plugins/types.go —
- plugin types init / component / component_list (types.go:20-28),
- run modes auto / manual (types.go:55-72),
- steps = bash scripts, plaintext or base64 (types.go:108-130),
- output parser: JSONPath extraction + match rules mapping to health
  states and suggested actions (types.go:132-176+),
- LoadSpecs/SaveSpecs (spec.go:52,78).

The port of ``gpud_tpu/plugins/spec.py``. ``yaml`` is imported where a
specs file is read or written, so a daemon with no plugins file never
loads it.
"""

from __future__ import annotations

import base64
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)


class PluginType:
    INIT = "init"
    COMPONENT = "component"
    COMPONENT_LIST = "component_list"

    _ALL = (INIT, COMPONENT, COMPONENT_LIST)


class RunMode:
    AUTO = "auto"
    MANUAL = "manual"

    _ALL = (AUTO, MANUAL)


@dataclass
class PluginStep:
    name: str = ""
    script: str = ""           # plaintext bash
    script_base64: str = ""    # alternative encoding

    def resolved_script(self) -> str:
        if self.script_base64:
            return base64.b64decode(self.script_base64).decode("utf-8")
        return self.script

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        if self.script_base64:
            d["script_base64"] = self.script_base64
        else:
            d["script"] = self.script
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PluginStep":
        if not isinstance(d, dict):
            raise ValueError(f"plugin step must be an object, got {type(d).__name__}")
        return cls(
            name=d.get("name", ""),
            script=d.get("script", ""),
            script_base64=d.get("script_base64", ""),
        )


@dataclass
class MatchRule:
    """If ``regex`` matches the extracted field (or raw output when no
    field), apply health/suggested actions."""

    regex: str = ""
    health: str = "Unhealthy"
    suggested_actions: List[str] = field(default_factory=list)
    description: str = ""
    # extracted-field name; empty = match the raw output. Declared last:
    # the attribute name shadows dataclasses.field inside the class body.
    field: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "regex": self.regex,
            "field": self.field,
            "health": self.health,
            "suggested_actions": list(self.suggested_actions),
            "description": self.description,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MatchRule":
        return cls(
            regex=d.get("regex", ""),
            field=d.get("field", ""),
            health=d.get("health", "Unhealthy"),
            suggested_actions=list(d.get("suggested_actions", []) or []),
            description=d.get("description", ""),
        )


@dataclass
class OutputParser:
    """``json_paths`` extract named fields from the last step's JSON output
    (dot-path syntax: ``$.a.b[0].c``); ``match_rules`` evaluate them."""

    json_paths: Dict[str, str] = field(default_factory=dict)  # field → path
    match_rules: List[MatchRule] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "json_paths": dict(self.json_paths),
            "match_rules": [r.to_dict() for r in self.match_rules],
        }

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "OutputParser":
        if not d:
            return cls()
        return cls(
            json_paths=dict(d.get("json_paths", {}) or {}),
            match_rules=[MatchRule.from_dict(r) for r in d.get("match_rules", []) or []],
        )


@dataclass
class PluginSpec:
    name: str = ""
    plugin_type: str = PluginType.COMPONENT
    run_mode: str = RunMode.AUTO
    interval_seconds: float = 60.0
    timeout_seconds: float = 60.0
    steps: List[PluginStep] = field(default_factory=list)
    parser: OutputParser = field(default_factory=OutputParser)
    tags: List[str] = field(default_factory=list)
    component_list: List[str] = field(default_factory=list)  # for component_list

    def validate(self) -> Optional[str]:
        if not self.name:
            return "plugin name required"
        if not re.fullmatch(r"[a-zA-Z0-9_.-]+", self.name):
            return f"invalid plugin name {self.name!r}"
        if self.plugin_type not in PluginType._ALL:
            return f"invalid plugin type {self.plugin_type!r}"
        if self.run_mode not in RunMode._ALL:
            return f"invalid run mode {self.run_mode!r}"
        if not self.steps:
            return "at least one step required"
        if self.plugin_type == PluginType.COMPONENT_LIST and not self.component_list:
            return "component_list plugins need a component_list"
        for rule in self.parser.match_rules:
            # a broken rule regex must be rejected here, at push time —
            # not explode inside the poller at 3am. An EMPTY regex matches
            # everything (a typoed YAML key silently defaults to "") and
            # would fire the rule on every poll — equally rejected.
            if not rule.regex:
                return "match rule with empty regex (typoed 'regex:' key?)"
            try:
                re.compile(rule.regex)
            except re.error as e:
                return f"invalid match-rule regex {rule.regex!r}: {e}"
        for s in self.steps:
            if not s.resolved_script().strip():
                return f"step {s.name!r} has an empty script"
        if self.interval_seconds < 1:
            return "interval must be >= 1s"
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "plugin_type": self.plugin_type,
            "run_mode": self.run_mode,
            "interval_seconds": self.interval_seconds,
            "timeout_seconds": self.timeout_seconds,
            "steps": [s.to_dict() for s in self.steps],
            "parser": self.parser.to_dict(),
            "tags": list(self.tags),
            "component_list": list(self.component_list),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PluginSpec":
        if not isinstance(d, dict):
            raise ValueError(f"plugin spec must be an object, got {type(d).__name__}")
        steps_raw = d.get("steps", []) or []
        if not isinstance(steps_raw, list):
            raise ValueError("plugin steps must be a list")
        return cls(
            name=d.get("name", ""),
            plugin_type=d.get("plugin_type", PluginType.COMPONENT),
            run_mode=d.get("run_mode", RunMode.AUTO),
            interval_seconds=float(d.get("interval_seconds", 60.0)),
            timeout_seconds=float(d.get("timeout_seconds", 60.0)),
            steps=[PluginStep.from_dict(s) for s in steps_raw],
            parser=OutputParser.from_dict(d.get("parser")),
            tags=list(d.get("tags", []) or []),
            component_list=list(d.get("component_list", []) or []),
        )


def specs_from_list(
    items: List[Dict[str, Any]], on_invalid: str = "raise"
) -> List[PluginSpec]:
    """``on_invalid="raise"`` is the push-time contract (setPluginSpecs
    rejects the whole batch); ``"skip"`` is boot-time leniency — an older
    or hand-edited plugins.yaml with one bad spec must degrade that
    plugin, not crash-loop the daemon (same rationale as the built-in
    name-clash skip in server.py)."""
    out: List[PluginSpec] = []
    names = set()
    for d in items:
        try:
            s = PluginSpec.from_dict(d)
            err = s.validate()
            if err:
                raise ValueError(f"plugin {s.name!r}: {err}")
            if s.name in names:
                raise ValueError(f"duplicate plugin name {s.name!r}")
        except (ValueError, KeyError):
            if on_invalid == "skip":
                logger.error("skipping invalid plugin spec: %r", d)
                continue
            raise
        names.add(s.name)
        out.append(s)
    return out


def load_specs(path: str, on_invalid: str = "raise") -> List[PluginSpec]:
    """Reference: pkg/custom-plugins/spec.go:52 LoadSpecs. Raises
    ImportError on a host without the ``yaml`` package."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or []
    if not isinstance(data, list):
        raise ValueError("plugin specs file must contain a YAML list")
    return specs_from_list(data, on_invalid=on_invalid)


def save_specs(path: str, specs: List[PluginSpec]) -> None:
    """Reference: pkg/custom-plugins/spec.go:78 SaveSpecs."""
    import os

    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump([s.to_dict() for s in specs], f, sort_keys=False)


# ---------------------------------------------------------------------------
# dot-path extraction (JSONPath-lite)
# ---------------------------------------------------------------------------

_PATH_TOKEN = re.compile(r"\.([A-Za-z0-9_-]+)|\[(\d+)\]")


def extract_path(obj: Any, path: str) -> Optional[Any]:
    """``$.a.b[0].c`` over parsed JSON. Returns None when absent."""
    if not path.startswith("$"):
        return None
    cur = obj
    for m in _PATH_TOKEN.finditer(path[1:]):
        key, idx = m.group(1), m.group(2)
        try:
            if key is not None:
                cur = cur[key]
            else:
                cur = cur[int(idx)]
        except (KeyError, IndexError, TypeError):
            return None
    return cur
