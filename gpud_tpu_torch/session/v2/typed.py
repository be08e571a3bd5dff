"""Rev-2 typed-request adaptation: ManagerPacket → dispatcher request.

The dispatcher's contract is a method-keyed dict (session/dispatch.py) —
shared by v1 JSON and rev-1 Frames. Rev 2 replaces the *wire* encoding
with per-method protobuf messages (reference:
pkg/session/v2/session.proto:16-60 ManagerPacket oneof); this module maps
each typed request onto the dispatcher contract, so the method surface
stays identical across protocol revisions. Responses travel back as
``Result{request_id, payload_json}`` (built in v2/client.py).

The port of ``gpud_tpu/session/v2/typed.py``. The generated messages
(``session_pb2``, which needs ``protobuf``) load on the first encode, so
importing this module loads no protobuf. ``InjectFaultRequest`` keeps its
wire fields ``tpu_error_name`` and ``chip_id`` (the protocol the manager
speaks); they carry the port's dispatcher keys ``gpu_error_name`` and
``gpu_id``.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Dict

if TYPE_CHECKING:
    from gpud_tpu_torch.session.v2 import session_pb2 as pb


def _pb():
    from gpud_tpu_torch.session.v2 import session_pb2

    return session_pb2

# oneof field name → dispatcher method name
FIELD_TO_METHOD = {
    "get_states": "states",
    "get_events": "events",
    "get_metrics": "metrics",
    "gossip": "gossip",
    "diagnostic": "diagnostic",
    "reboot": "reboot",
    "set_healthy": "setHealthy",
    "trigger_component": "triggerComponent",
    "deregister_component": "deregisterComponent",
    "inject_fault": "injectFault",
    "bootstrap": "bootstrap",
    "update_config": "updateConfig",
    "update_token": "updateToken",
    "get_token": "getToken",
    "logout": "logout",
    "delete_machine": "delete",
    "get_package_status": "packageStatus",
    "update": "update",
    "kap_mtls_status": "kapMTLSStatus",
    "kap_mtls_update_credentials": "kapMTLSUpdateCredentials",
    "kap_mtls_activate": "kapMTLSActivate",
    "get_plugin_specs": "getPluginSpecs",
    "set_plugin_specs": "setPluginSpecs",
}


class UnsupportedRequest(Exception):
    """The manager sent a payload this agent revision doesn't know —
    either a newer oneof field (decodes as no payload) or one without a
    dispatcher mapping. The agent answers an error Result rather than
    dropping the request_id on the floor."""


def request_to_dict(mpkt: pb.ManagerPacket) -> Dict:
    """Typed ManagerPacket → dispatcher request dict.

    Raises UnsupportedRequest for payloads outside the rev-2 method set.
    Parameter names match the v1 JSON contract exactly — the dispatcher
    is revision-agnostic.
    """
    kind = mpkt.WhichOneof("payload")
    if kind is None:
        raise UnsupportedRequest("no recognizable payload (manager newer than agent?)")
    method = FIELD_TO_METHOD.get(kind)
    if method is None:
        raise UnsupportedRequest(f"non-request payload {kind!r}")
    req: Dict = {"method": method}
    msg = getattr(mpkt, kind)

    if kind == "get_states":
        if msg.components:
            req["components"] = list(msg.components)
    elif kind in ("get_events", "get_metrics"):
        if msg.since_unix:
            req["since"] = msg.since_unix
    elif kind == "diagnostic":
        if msg.script_base64:
            req["script_base64"] = msg.script_base64
        if msg.since_unix:
            req["since"] = msg.since_unix
        if msg.timeout_seconds:
            req["timeout_seconds"] = msg.timeout_seconds
    elif kind == "reboot":
        if msg.delay_seconds:
            req["delay_seconds"] = msg.delay_seconds
    elif kind == "set_healthy":
        req["component"] = msg.component
    elif kind == "trigger_component":
        req["component"] = msg.component
        req["tag"] = msg.tag
    elif kind == "deregister_component":
        req["component"] = msg.component
    elif kind == "inject_fault":
        fault = msg.WhichOneof("fault")
        if fault == "tpu_error_name":
            req["gpu_error_name"] = msg.tpu_error_name
        elif fault == "kernel_message":
            req["kernel_message"] = msg.kernel_message.message
            if msg.kernel_message.HasField("priority"):
                req["priority"] = msg.kernel_message.priority
        if msg.chip_id:
            req["gpu_id"] = msg.chip_id
        if msg.detail:
            req["detail"] = msg.detail
    elif kind == "bootstrap":
        req["script_base64"] = msg.script_base64
        if msg.timeout_seconds:
            req["timeout_seconds"] = msg.timeout_seconds
    elif kind == "update_config":
        configs: Dict = {}
        for section, raw in msg.configs_json.items():
            try:
                configs[section] = json.loads(raw)
            except ValueError as e:
                raise UnsupportedRequest(
                    f"updateConfig section {section!r}: invalid JSON ({e})"
                ) from e
        req["configs"] = configs
    elif kind == "update_token":
        req["token"] = msg.token
    elif kind == "update":
        req["version"] = msg.version
    elif kind == "kap_mtls_update_credentials":
        req["version"] = msg.version
        req["cert_pem"] = msg.cert_pem
        req["key_pem"] = msg.key_pem
        req["activate"] = msg.activate
    elif kind == "kap_mtls_activate":
        req["version"] = msg.version
    elif kind == "set_plugin_specs":
        req["specs"] = [_plugin_spec_to_dict(s) for s in msg.specs]
    # gossip / get_token / logout / delete_machine / get_package_status /
    # kap_mtls_status / get_plugin_specs carry no parameters

    return req


def _plugin_spec_to_dict(spec: pb.PluginSpec) -> Dict:
    """Typed PluginSpec → the plugins.spec JSON contract
    (plugins/spec.py PluginSpec.from_dict)."""
    out: Dict = {
        "name": spec.name,
        "steps": [
            {
                "name": st.name,
                **(
                    {"script_base64": st.script_base64}
                    if st.script_base64
                    else {"script": st.script}
                ),
            }
            for st in spec.steps
        ],
    }
    if spec.plugin_type:
        out["plugin_type"] = spec.plugin_type
    if spec.run_mode:
        out["run_mode"] = spec.run_mode
    if spec.interval_seconds:
        out["interval_seconds"] = spec.interval_seconds
    if spec.timeout_seconds:
        out["timeout_seconds"] = spec.timeout_seconds
    if spec.tags:
        out["tags"] = list(spec.tags)
    if spec.component_list:
        out["component_list"] = list(spec.component_list)
    if spec.HasField("parser"):
        out["parser"] = {
            "json_paths": dict(spec.parser.json_paths),
            "match_rules": [
                {
                    "regex": r.regex,
                    "field": r.field,
                    "health": r.health or "Unhealthy",
                    "suggested_actions": list(r.suggested_actions),
                    "description": r.description,
                }
                for r in spec.parser.match_rules
            ],
        }
    return out


METHOD_TO_FIELD = {m: f for f, m in FIELD_TO_METHOD.items()}


def dict_to_request(req: Dict, request_id: str) -> pb.ManagerPacket:
    """Manager-side encoder: dispatcher request dict → typed ManagerPacket.

    The exact inverse of :func:`request_to_dict` (roundtrip-tested per
    method); the standalone control plane uses it to speak rev 2 from the
    same method-dict surface the v1 transport uses.
    """
    method = req.get("method")
    field = METHOD_TO_FIELD.get(method or "")
    if field is None:
        raise UnsupportedRequest(f"no typed encoding for method {method!r}")
    mpkt = _pb().ManagerPacket()
    mpkt.request_id = request_id
    msg = getattr(mpkt, field)
    msg.SetInParent()  # parameterless requests still select the oneof arm

    if field == "get_states":
        msg.components.extend(req.get("components") or [])
    elif field in ("get_events", "get_metrics"):
        if req.get("since"):
            msg.since_unix = float(req["since"])
    elif field == "diagnostic":
        if req.get("script_base64"):
            msg.script_base64 = req["script_base64"]
        if req.get("since"):
            msg.since_unix = float(req["since"])
        if req.get("timeout_seconds"):
            msg.timeout_seconds = float(req["timeout_seconds"])
    elif field == "reboot":
        if req.get("delay_seconds"):
            msg.delay_seconds = float(req["delay_seconds"])
    elif field in ("set_healthy", "deregister_component"):
        msg.component = req.get("component", "")
    elif field == "trigger_component":
        msg.component = req.get("component", "")
        msg.tag = req.get("tag", "")
    elif field == "inject_fault":
        if req.get("gpu_error_name"):
            msg.tpu_error_name = req["gpu_error_name"]
        elif req.get("kernel_message"):
            msg.kernel_message.message = req["kernel_message"]
            if req.get("priority") is not None:
                msg.kernel_message.priority = int(req["priority"])
        if req.get("gpu_id"):
            msg.chip_id = int(req["gpu_id"])
        if req.get("detail"):
            msg.detail = req["detail"]
    elif field == "bootstrap":
        msg.script_base64 = req.get("script_base64", "")
        if req.get("timeout_seconds"):
            msg.timeout_seconds = float(req["timeout_seconds"])
    elif field == "update_config":
        for section, value in (req.get("configs") or {}).items():
            msg.configs_json[section] = json.dumps(value)
    elif field == "update_token":
        msg.token = req.get("token", "")
    elif field == "update":
        msg.version = req.get("version", "")
    elif field == "kap_mtls_update_credentials":
        msg.version = req.get("version", "")
        msg.cert_pem = req.get("cert_pem", "")
        msg.key_pem = req.get("key_pem", "")
        msg.activate = bool(req.get("activate"))
    elif field == "kap_mtls_activate":
        msg.version = req.get("version", "")
    elif field == "set_plugin_specs":
        for spec in req.get("specs") or []:
            msg.specs.append(_plugin_spec_from_dict(spec))
    return mpkt


def _plugin_spec_from_dict(spec: Dict) -> pb.PluginSpec:
    out = _pb().PluginSpec()
    out.name = spec.get("name", "")
    out.plugin_type = spec.get("plugin_type", "")
    out.run_mode = spec.get("run_mode", "")
    out.interval_seconds = float(spec.get("interval_seconds") or 0)
    out.timeout_seconds = float(spec.get("timeout_seconds") or 0)
    out.tags.extend(spec.get("tags") or [])
    out.component_list.extend(spec.get("component_list") or [])
    for st in spec.get("steps") or []:
        step = out.steps.add()
        step.name = st.get("name", "")
        if st.get("script_base64"):
            step.script_base64 = st["script_base64"]
        elif st.get("script"):
            step.script = st["script"]
    parser = spec.get("parser")
    if parser is not None:
        for k, v in (parser.get("json_paths") or {}).items():
            out.parser.json_paths[k] = v
        for r in parser.get("match_rules") or []:
            rule = out.parser.match_rules.add()
            rule.regex = r.get("regex", "")
            rule.field = r.get("field", "")
            rule.health = r.get("health", "Unhealthy")
            rule.suggested_actions.extend(r.get("suggested_actions") or [])
            rule.description = r.get("description", "")
        out.parser.SetInParent()
    return out


def make_result(
    request_id: str, payload: Dict, compress: bool = False
) -> pb.AgentPacket:
    """``compress=True`` applies the rev-3 wire framing (1-byte codec
    prefix, zlib above the size floor — session/wire.py); only valid
    once the handshake negotiated revision >= 3. Default is the rev-2
    bare-JSON encoding."""
    pkt = _pb().AgentPacket()
    pkt.result.request_id = request_id
    if compress:
        from gpud_tpu_torch.session import wire

        pkt.result.payload_json = wire.encode_payload(payload)
    else:
        pkt.result.payload_json = json.dumps(payload).encode("utf-8")
    return pkt


def error_result(
    request_id: str, message: str, compress: bool = False
) -> pb.AgentPacket:
    return make_result(request_id, {"error": message}, compress=compress)


def negotiate_revision(ack_revision: int, max_supported: int) -> int:
    """Manager's acked revision clamped to what this agent speaks; 0 (an
    old manager that never sets the field) means rev 1."""
    if ack_revision <= 0:
        return 1
    return min(ack_revision, max_supported)
