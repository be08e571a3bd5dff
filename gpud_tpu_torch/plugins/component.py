"""Plugin components: execute spec steps, parse output, evaluate health;
the port of ``gpud_tpu/plugins/component.py``.

Reference: pkg/custom-plugins/component.go — exit-code contract (non-zero ⇒
Unhealthy), component naming, registration into the init or component
registry at pkg/server/server.go:344-387 (init plugins run once at boot and
an unhealthy result fails the boot).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import (
    ComponentType,
    HealthStateType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.plugins.spec import PluginSpec, PluginType, RunMode, extract_path
from gpud_tpu_torch.process import ExclusiveRunner

logger = get_logger(__name__)

# one shared runner: plugin scripts never run concurrently
# (reference: pkg/process ExclusiveRunner)
_RUNNER = ExclusiveRunner()


def _find_json(output: str) -> Optional[object]:
    """Best-effort: parse the last JSON object/array found in the output."""
    for line in reversed(output.strip().splitlines()):
        line = line.strip()
        if line.startswith("{") or line.startswith("["):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


class PluginComponent(PollingComponent):
    """One spec → one component (or one per list item)."""

    def __init__(
        self,
        instance: TpudInstance,
        spec: PluginSpec,
        item: str = "",
        runner: Optional[ExclusiveRunner] = None,
    ) -> None:
        self.spec = spec
        self.item = item
        self.NAME = spec.name if not item else f"{spec.name}.{item}"
        self.TAGS = list(spec.tags) or ["custom-plugin"]
        self.POLL_INTERVAL = spec.interval_seconds
        super().__init__(instance)
        self.runner = runner or _RUNNER

    # custom plugins are deregisterable (reference: components/types.go:69-75)
    def can_deregister(self) -> bool:
        return True

    def start(self) -> None:
        if self.spec.run_mode == RunMode.MANUAL:
            return  # manual plugins only run via trigger-check
        super().start()

    def check_once(self) -> CheckResult:
        env = {"TPUD_PLUGIN_NAME": self.spec.name}
        if self.item:
            env["TPUD_PLUGIN_ITEM"] = self.item
        combined_output = []
        for step in self.spec.steps:
            r = self.runner.run_script(
                self.NAME,
                step.resolved_script(),
                timeout=self.spec.timeout_seconds,
                env=env,
            )
            combined_output.append(r.output)
            if r.timed_out:
                return self._result(
                    HealthStateType.UNHEALTHY,
                    f"step {step.name or '?'} timed out after {self.spec.timeout_seconds}s",
                    "\n".join(combined_output),
                )
            if r.exit_code != 0:
                # exit-code contract: non-zero ⇒ Unhealthy
                return self._result(
                    HealthStateType.UNHEALTHY,
                    f"step {step.name or '?'} exited {r.exit_code}",
                    "\n".join(combined_output),
                )
        output = "\n".join(combined_output)
        return self._parse(output)

    def _parse(self, output: str) -> CheckResult:
        parser = self.spec.parser
        extracted: Dict[str, str] = {}
        if parser.json_paths:
            doc = _find_json(output)
            if doc is not None:
                for fname, path in parser.json_paths.items():
                    v = extract_path(doc, path)
                    if v is not None:
                        extracted[fname] = v if isinstance(v, str) else json.dumps(v)
        for rule in parser.match_rules:
            target = extracted.get(rule.field, "") if rule.field else output
            if re.search(rule.regex, target):
                sa = None
                if rule.suggested_actions:
                    sa = SuggestedActions(
                        description=rule.description or f"plugin {self.NAME} matched {rule.regex!r}",
                        repair_actions=list(rule.suggested_actions),
                    )
                return self._result(
                    rule.health,
                    rule.description or f"matched {rule.regex!r}",
                    output,
                    extracted,
                    sa,
                )
        return self._result(HealthStateType.HEALTHY, "ok", output, extracted)

    def _result(
        self,
        health: str,
        reason: str,
        output: str,
        extracted: Optional[Dict[str, str]] = None,
        sa: Optional[SuggestedActions] = None,
    ) -> CheckResult:
        return CheckResult(
            self.NAME,
            health=health,
            reason=reason,
            suggested_actions=sa,
            extra_info=extracted or {},
            component_type=ComponentType.CUSTOM_PLUGIN,
            run_mode=self.spec.run_mode,
            raw_output=output,
        )


def build_components(
    instance: TpudInstance, specs: List[PluginSpec]
) -> List[PluginComponent]:
    """Expand specs into components (component_list fans out one per item,
    reference: types.go component_list semantics)."""
    out: List[PluginComponent] = []
    for spec in specs:
        if spec.plugin_type == PluginType.COMPONENT_LIST:
            for item in spec.component_list:
                out.append(PluginComponent(instance, spec, item=item))
        elif spec.plugin_type == PluginType.COMPONENT:
            out.append(PluginComponent(instance, spec))
    return out


def run_init_plugins(
    instance: TpudInstance, specs: List[PluginSpec]
) -> Optional[str]:
    """Run init-type plugins once; an unhealthy result fails daemon boot
    (reference: pkg/server/server.go:343-387). Returns error or None."""
    for spec in specs:
        if spec.plugin_type != PluginType.INIT:
            continue
        comp = PluginComponent(instance, spec)
        cr = comp.check()
        if cr.health_state_type() != HealthStateType.HEALTHY:
            return f"init plugin {spec.name!r} unhealthy: {cr.summary()}"
    return None
