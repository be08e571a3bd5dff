"""HTTP API routes; the port of ``gpud_tpu/server/app.py`` on the standard
library.

Reference: pkg/server routes (handlers_components.go:20-31,
handlers_plugins.go:14-17, handlers_healthz.go:10,
handlers_machine_info.go:13, handlers_inject_fault.go:13,
server.go:402-434):

  GET  /healthz
  GET  /v1/components            DELETE /v1/components?componentName=
  GET  /v1/components/trigger-check?componentName=|tagName=
  POST /v1/components/set-healthy?componentName=
  GET  /v1/states[?components=]
  GET  /v1/events[?startTime=&endTime=]
  GET  /v1/metrics[?since=]
  GET  /v1/info
  GET  /metrics                  (Prometheus text)
  GET  /machine-info
  POST /inject-fault
  GET  /admin/config
  GET  /admin/packages

The reference serves these with aiohttp; here one table of ``Route``
(method, path, handler, summary) built by ``build_routes`` is the single
source for dispatch (``App.handle``), for the 404 and 405 answers (with
aiohttp's bodies and ``Allow`` header; a GET route answers HEAD too), for
the per-request metrics and trace record (the reference's
``observe_middleware``) and for ``/openapi.json``. Handlers take a
``Request`` and return a ``Response``; the server (``server.py``) runs each
connection on its own thread, so a handler blocks where the reference's
awaits its executor.

``App`` also serves another route table (``App(routes=...)``, as the
manager's ``manager/control_plane.py`` does): a path may hold
``{name}`` segments, matched as aiohttp's router matches them and handed
to the handler in ``Request.match_info``. A route with ``stream_body``
reads its request body itself from ``Request.stream``, and a ``Response``
with ``chunks`` is sent chunked, one chunk per item, as aiohttp's
``StreamResponse`` sends each ``write``.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, BinaryIO, Callable, Dict, Iterable, List, Mapping, Optional

from gpud_tpu_torch.api.v1.types import (
    ComponentEvents,
    ComponentHealthStates,
    ComponentInfo,
    ComponentMetrics,
    HealthState,
)
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, histogram
from gpud_tpu_torch.tracing import DEFAULT_TRACER

if TYPE_CHECKING:
    from gpud_tpu_torch.server.server import Server

logger = get_logger(__name__)

DEFAULT_EVENTS_LOOKBACK = 3 * 3600  # /v1/events default window
DEFAULT_METRICS_LOOKBACK = 3 * 3600
DEFAULT_HISTORY_LOOKBACK = 24 * 3600  # /v1/states/history default window
DEFAULT_HISTORY_LIMIT = 256

# Prometheus text exposition content type (the scraper negotiates on the
# version parameter; a bare text/plain is accepted but non-conformant)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

DEFAULT_TRACES_LIMIT = 256

HTTP_DURATION = ("tpud_http_request_duration_seconds",
                 "HTTP API request latency by route and method")
HTTP_REQUESTS = ("tpud_http_requests_total",
                 "HTTP API requests by route, method and status code")

UNMATCHED = "unmatched"


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str] = field(default_factory=dict)  # first value per key
    body: bytes = b""
    headers: Mapping[str, str] = field(default_factory=dict)  # case-insensitive from the server
    match_info: Dict[str, str] = field(default_factory=dict)  # the path's {name} segments
    stream: Optional[BinaryIO] = None  # the unread body, for a ``stream_body`` route

    def json(self):
        """The body as JSON; raises ``json.JSONDecodeError`` or
        ``UnicodeDecodeError`` as aiohttp's ``Request.json`` does."""
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    headers: Dict[str, str] = field(default_factory=dict)
    chunks: Optional[Iterable[bytes]] = None  # sent chunked in place of ``body``


class HTTPError(Exception):
    """A handler's early answer (aiohttp's ``web.HTTPException``)."""

    def __init__(self, response: Response) -> None:
        super().__init__(response.status)
        self.response = response


@dataclass
class Route:
    method: str
    path: str
    handler: Callable[[Request], Response]
    summary: str
    stream_body: bool = False


# aiohttp's dynamic segment: ``{name}`` matches one non-empty path segment
_SEGMENT = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)\}")


def _template(path: str):
    """The compiled pattern of a route path with ``{name}`` segments, or
    None for a plain path."""
    if "{" not in path:
        return None
    out, pos = [], 0
    for m in _SEGMENT.finditer(path):
        out.append(re.escape(path[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>[^{{}}/]+)")
        pos = m.end()
    out.append(re.escape(path[pos:]))
    return re.compile("".join(out) + r"\Z")


def _json(data, status: int = 200) -> Response:
    return Response(status=status, body=json.dumps(data).encode("utf-8"))


def _text(text: str, status: int = 200,
          content_type: str = "text/plain; charset=utf-8") -> Response:
    return Response(status=status, body=text.encode("utf-8"), content_type=content_type)


def _components_filter(request: Request):
    raw = request.query.get("components", "")
    return [c for c in raw.split(",") if c] or None


def _qfloat(req: Request, key: str, default: float) -> float:
    """Numeric query param; malformed input is a 400, not an unhandled 500
    (reference returns 400 on bad query input)."""
    raw = req.query.get(key)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise HTTPError(_json({"error": f"invalid {key}: {raw!r}"}, 400))


def build_routes(srv: "Server") -> List[Route]:
    """The route table, in the reference's registration order
    (app.py:607-672): the pprof routes first when ``config.pprof``."""
    from gpud_tpu_torch import machine_info as machineinfo
    from gpud_tpu_torch.fault_injector import Request as InjectRequest

    def healthz(_req: Request) -> Response:
        return _json({"status": "ok", "version": srv.version})

    def list_components(_req: Request) -> Response:
        return _json(srv.registry.names())

    def deregister_component(req: Request) -> Response:
        name = req.query.get("componentName", "")
        comp = srv.registry.get(name)
        if comp is None:
            return _json({"error": f"component {name!r} not found"}, 404)
        if not comp.can_deregister():
            return _json({"error": f"component {name!r} is not deregisterable"}, 400)
        comp = srv.registry.deregister(name)
        if comp is not None:
            comp.close()
        return _json({"deregistered": name})

    def trigger_check(req: Request) -> Response:
        name = req.query.get("componentName", "")
        tag = req.query.get("tagName", "")
        comps = []
        if name:
            c = srv.registry.get(name)
            if c is None:
                return _json({"error": f"component {name!r} not found"}, 404)
            comps = [c]
        elif tag:
            comps = [c for c in srv.registry.all() if tag in c.tags()]
            if not comps:
                return _json({"error": f"no components with tag {tag!r}"}, 404)
        else:
            return _json({"error": "componentName or tagName required"}, 400)
        out = []
        for c in comps:
            cr = c.check()
            out.append(
                ComponentHealthStates(
                    component=c.name(), states=cr.health_states()
                ).to_dict()
            )
        return _json(out)

    def set_healthy(req: Request) -> Response:
        name = req.query.get("componentName", "")
        c = srv.registry.get(name)
        if c is None:
            return _json({"error": f"component {name!r} not found"}, 404)
        fn = getattr(c, "set_healthy", None)
        if fn is None:
            return _json({"error": f"component {name!r} is not health-settable"}, 400)
        fn()
        return _json({"set_healthy": name})

    def states(req: Request) -> Response:
        comps = _components_filter(req)
        out = []
        for c in srv.registry.all():
            if comps and c.name() not in comps:
                continue
            if not comps and c.name() not in srv.supported_names:
                continue  # unsupported components are skipped unless asked for
            out.append(
                ComponentHealthStates(
                    component=c.name(), states=c.last_health_states()
                ).to_dict()
            )
        return _json(out)

    def events(req: Request) -> Response:
        now = time.time()
        start = _qfloat(req, "startTime", now - DEFAULT_EVENTS_LOOKBACK)
        end = _qfloat(req, "endTime", now)
        comps = _components_filter(req)
        out = []
        for c in srv.registry.all():
            if comps and c.name() not in comps:
                continue
            if not comps and c.name() not in srv.supported_names:
                continue
            evs = [e for e in c.events(start) if e.time <= end]
            out.append(
                ComponentEvents(
                    component=c.name(), start_time=start, end_time=end, events=evs
                ).to_dict()
            )
        return _json(out)

    def metrics_v1(req: Request) -> Response:
        now = time.time()
        since = _qfloat(req, "since", now - DEFAULT_METRICS_LOOKBACK)
        comps = _components_filter(req)
        ms = srv.metrics_store.read(since, components=comps)
        by_comp: Dict[str, list] = {}
        for m in ms:
            comp = m.labels.get("component", "")
            by_comp.setdefault(comp, []).append(m)
        return _json(
            [
                ComponentMetrics(component=k, metrics=v).to_dict()
                for k, v in sorted(by_comp.items())
            ]
        )

    def info(req: Request) -> Response:
        now = time.time()
        start = _qfloat(req, "startTime", now - DEFAULT_EVENTS_LOOKBACK)
        comps = _components_filter(req)
        ms = srv.metrics_store.read(start, components=comps)
        metrics_by_comp: Dict[str, list] = {}
        for m in ms:
            metrics_by_comp.setdefault(m.labels.get("component", ""), []).append(m)
        out = []
        for c in srv.registry.all():
            if comps and c.name() not in comps:
                continue
            if not comps and c.name() not in srv.supported_names:
                continue
            out.append(
                ComponentInfo(
                    component=c.name(),
                    start_time=start,
                    end_time=now,
                    states=c.last_health_states(),
                    events=c.events(start),
                    metrics=metrics_by_comp.get(c.name(), []),
                ).to_dict()
            )
        if not comps:
            # self-observability summary rides along as a pseudo-component
            # entry so existing list-shaped consumers keep parsing
            out.append(_self_info_entry(srv, start, now))
        return _json(out)

    def states_history(req: Request) -> Response:
        """Persisted health-transition timeline from the ledger
        (?component=&since=&limit=&correlationSeconds=); each transition
        carries the eventstore events within ±correlation window."""
        ledger = srv.health_ledger
        component = req.query.get("component", "") or None
        since = _qfloat(req, "since", time.time() - DEFAULT_HISTORY_LOOKBACK)
        limit = int(_qfloat(req, "limit", DEFAULT_HISTORY_LIMIT))
        if limit < 0:
            limit = DEFAULT_HISTORY_LIMIT
        corr = _qfloat(req, "correlationSeconds", ledger.correlation_window)
        transitions = ledger.history(component=component, since=since, limit=limit)
        ledger.annotate_with_events(transitions, window=corr)
        out = {
            "transitions": transitions,
            "count": len(transitions),
            "flapping": ledger.flapping_components(),
        }
        if component:
            av = ledger.availability(component)
            if av is not None:
                out["availability"] = av
        return _json(out)

    def remediation_audit(req: Request) -> Response:
        """Remediation audit ledger: every policy decision and repair
        attempt (?component=&action=&outcome=&since=&limit=), newest
        first, plus the engine's guard-state rollup."""
        eng = srv.remediation
        if eng is None:
            return _json({"error": "remediation engine disabled"}, 404)
        component = req.query.get("component", "") or None
        action = req.query.get("action", "") or None
        outcome = req.query.get("outcome", "") or None
        since = _qfloat(req, "since", 0.0)
        limit = int(_qfloat(req, "limit", DEFAULT_HISTORY_LIMIT))
        if limit < 0:
            limit = DEFAULT_HISTORY_LIMIT
        attempts = eng.audit.read(
            component=component, action=action, outcome=outcome,
            since=since, limit=limit,
        )
        return _json({"attempts": attempts, "count": len(attempts), "status": eng.status()})

    def predict_scores(req: Request) -> Response:
        """Precursor scores (docs/predict.md): per-component fused score,
        feature breakdown, armed/warned state, and measured lead times
        (?component= narrows; ?history=N appends the last N in-memory
        score points per component)."""
        eng = srv.predictor
        if eng is None:
            return _json({"error": "predict engine disabled"}, 404)
        component = req.query.get("component", "")
        history = int(_qfloat(req, "history", 0.0))
        if history < 0:
            history = 0
        out = eng.scores(component=component, history_limit=history)
        out["status"] = eng.status()
        return _json(out)

    def predict_calibration(req: Request) -> Response:
        """Threshold calibration state (docs/predict.md): per-class
        fitted thresholds/weights replayed from the node's own ledger
        history, with provenance (calibrated vs thin-history default).
        ?refit=1 re-fits synchronously before answering."""
        eng = srv.predictor
        if eng is None:
            return _json({"error": "predict engine disabled"}, 404)
        if req.query.get("refit", "") in ("1", "true"):
            eng.calibrate_now()
        return _json(eng.calibration())

    def fabric_matrix(req: Request) -> Response:
        """Fabric observability (docs/fabric.md): discovered mesh, sweep
        status, and the current per-link (src_chip, dst_chip, axis,
        latency, state) matrix. ?link=, ?since=, or ?limit= appends
        matrix history rows from the durable store (newest first)."""
        plane = getattr(srv, "fabric", None)
        if plane is None:
            return _json({"error": "fabric plane disabled"}, 404)
        link = req.query.get("link", "")
        since = _qfloat(req, "since", 0.0)
        limit = int(_qfloat(req, "limit", 0.0))
        out = {"status": plane.status(), "matrix": plane.matrix()}
        if link or since > 0 or limit > 0:
            out["history"] = plane.history(
                link=link, since=since, limit=limit if limit > 0 else 256
            )
        return _json(out)

    def remediation_policy_get(_req: Request) -> Response:
        """Current remediation policy and guard state (allowlist,
        cooldown, rate limit, reboot-window, escalation)."""
        eng = srv.remediation
        if eng is None:
            return _json({"error": "remediation engine disabled"}, 404)
        return _json(eng.status())

    def remediation_policy_post(req: Request) -> Response:
        """Update the remediation policy at runtime: partial JSON object of
        policy fields (enforce_actions graduates an action out of
        dry-run). Audited; invalid keys are rejected field-by-field."""
        eng = srv.remediation
        if eng is None:
            return _json({"error": "remediation engine disabled"}, 404)
        try:
            body = req.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _json({"error": "invalid JSON body"}, 400)
        if not isinstance(body, dict):
            return _json({"error": "body must be a JSON object"}, 400)
        from gpud_tpu_torch.log import audit as audit_log

        updated, errors = eng.policy.update(body)
        if updated:
            audit_log("remediation_policy_update", updated=",".join(updated))
        out = {"status": "ok" if not errors else "partial", "updated": updated}
        if errors:
            out["errors"] = errors
        return _json(out, 200 if updated or not errors else 400)

    def prometheus(_req: Request) -> Response:
        return _text(srv.metrics_registry.render_prometheus(),
                     content_type=PROMETHEUS_CONTENT_TYPE)

    def debug_traces(req: Request) -> Response:
        """Recent spans from the in-process trace ring, newest first
        (?component= filters, ?since= unix-ts floor, ?limit= caps,
        ?correlation_id= matches the id a check run stamped on its root
        span; see docs/observability.md). Malformed numeric params are a
        400."""
        component = req.query.get("component", "") or None
        correlation_id = req.query.get("correlation_id", "") or None
        limit = int(_qfloat(req, "limit", DEFAULT_TRACES_LIMIT))
        if limit < 0:
            limit = DEFAULT_TRACES_LIMIT
        since = _qfloat(req, "since", 0.0)
        stats = srv.tracer.stats()
        return _json(
            {
                "spans": srv.tracer.snapshot(
                    component=component, limit=limit, since=since,
                    correlation_id=correlation_id,
                ),
                "stats": stats,
                # surfaced at the envelope level: a consumer paging the ring
                # must see at a glance whether spans fell out under it
                "dropped_total": stats["dropped_total"],
            }
        )

    def machine_info_handler(_req: Request) -> Response:
        mi = machineinfo.get_machine_info(gpu=srv.gpu_instance, machine_id=srv.machine_id)
        return _json(mi.to_dict())

    def inject_fault(req: Request) -> Response:
        try:
            body = req.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            # non-UTF8 bytes raise UnicodeDecodeError before JSON parsing
            return _json({"error": "invalid JSON body"}, 400)
        if not isinstance(body, dict):
            return _json({"error": "body must be a JSON object"}, 400)
        try:
            ir = InjectRequest.from_dict(body)
        except (TypeError, ValueError) as e:
            return _json({"error": f"invalid inject request: {e}"}, 400)
        res = srv.fault_injector.inject(ir)
        if not res.ok:
            return _json({"error": res.error, **res.to_dict()}, 400)
        return _json({"injected": True, **res.to_dict()})

    def chaos_run(req: Request) -> Response:
        """Run a chaos campaign (body: scenario name or inline mapping;
        wait=false launches it on the pool and returns immediately)."""
        if srv.chaos is None:
            return _json({"error": "chaos is disabled (chaos_enabled)"}, 400)
        try:
            body = req.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _json({"error": "invalid JSON body"}, 400)
        if not isinstance(body, dict):
            return _json({"error": "body must be a JSON object"}, 400)
        out, err = srv.chaos.run_campaign(body.get("scenario"), wait=bool(body.get("wait", True)))
        if err:
            return _json({"error": err}, 400)
        return _json(out)

    def chaos_campaigns(req: Request) -> Response:
        """Chaos campaign results (newest first) + available scenarios
        (?limit= caps the history returned)."""
        if srv.chaos is None:
            return _json({"error": "chaos is disabled (chaos_enabled)"}, 400)
        limit = int(_qfloat(req, "limit", 0.0))
        return _json(srv.chaos.campaigns(limit=max(0, limit)))

    def session_status(_req: Request) -> Response:
        """Control-plane session health: connection + auth state, circuit
        breaker, and the store-and-forward outbox backlog/watermark."""
        out: dict = {
            "configured": srv.session is not None,
            "degraded": _session_degraded(srv),
        }
        session = srv.session
        if session is not None:
            out["session"] = {
                "endpoint": session.endpoint,
                "connected": session.connected,
                "auth_failed": session.auth_failed,
                "connect_attempts": getattr(session, "connect_attempts", 0),
                "last_connect_error": session.last_connect_error,
            }
        circuit = getattr(srv, "session_circuit", None)
        if circuit is not None:
            out["circuit"] = circuit.stats()
        outbox = getattr(srv, "outbox", None)
        if outbox is not None:
            out["outbox"] = outbox.stats()
        from gpud_tpu_torch.session import wire

        out["wire"] = wire.codec_stats()
        jitter = getattr(srv, "last_replay_jitter_seconds", None)
        if jitter is not None:
            out["last_replay_jitter_seconds"] = round(jitter, 3)
        return _json(out)

    def admin_config(_req: Request) -> Response:
        cfg = srv.config
        # the local API is unauthenticated — never serve credentials
        redacted = {"token", "machine_proof"}
        return _json(
            {
                k: ("<redacted>" if k in redacted and v else v)
                for k, v in vars(cfg).items()
                if isinstance(v, (str, int, float, bool, list))
            }
        )

    def admin_packages(_req: Request) -> Response:
        if srv.package_manager is None:
            return _json([])
        return _json([s.to_dict() for s in srv.package_manager.status()])

    def plugins(_req: Request) -> Response:
        specs = srv.plugin_specs or []
        return _json([s.to_dict() for s in specs])

    # -- debug/profiling, gated by --pprof (reference: pkg/server
    #    /admin/pprof/{profile,heap,trace}, server.go:425-434) ------------
    def pprof_profile(req: Request) -> Response:
        """Wall-clock sampling profiler over ALL threads (cProfile is
        per-thread and would only see this handler sleeping; Go pprof — the
        reference — samples every goroutine, so sample _current_frames)."""
        import collections
        import sys as _sys

        seconds = min(60.0, _qfloat(req, "seconds", 5.0))
        interval = 0.01
        counts: collections.Counter = collections.Counter()
        deadline = time.monotonic() + seconds
        samples = 0
        while time.monotonic() < deadline:
            for frame in _sys._current_frames().values():  # noqa: SLF001
                co = frame.f_code
                counts[f"{co.co_filename}:{frame.f_lineno} {co.co_name}"] += 1
            samples += 1
            time.sleep(interval)
        lines = [f"# {samples} samples over {seconds}s ({interval * 1e3:.0f}ms interval)"]
        for loc, n in counts.most_common(60):
            lines.append(f"{n:6d}  {loc}")
        return _text("\n".join(lines) + "\n")

    def pprof_heap(_req: Request) -> Response:
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return _text("tracemalloc started; re-request for a snapshot\n")
        snap = tracemalloc.take_snapshot()
        # stop after the snapshot: per-allocation tracing must not keep
        # taxing a long-lived monitoring daemon after one debug request
        tracemalloc.stop()
        lines = [str(s) for s in snap.statistics("lineno")[:50]]
        return _text("\n".join(lines) + "\n")

    def pprof_threads(_req: Request) -> Response:
        import sys as _sys
        import threading as _threading
        import traceback as _traceback

        names = {t.ident: t.name for t in _threading.enumerate()}
        parts = []
        for tid, frame in _sys._current_frames().items():  # noqa: SLF001
            parts.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
            parts.append("".join(_traceback.format_stack(frame)))
        return _text("\n".join(parts))

    routes: List[Route] = []

    def add(method: str, path: str, handler: Callable[[Request], Response]) -> None:
        doc = (handler.__doc__ or "").strip().split("\n")[0]
        routes.append(Route(method, path, handler, doc or handler.__name__))

    if srv.config.pprof:
        add("GET", "/admin/pprof/profile", pprof_profile)
        add("GET", "/admin/pprof/heap", pprof_heap)
        add("GET", "/admin/pprof/threads", pprof_threads)

    def openapi(_req: Request) -> Response:
        """Machine-readable API description (reference: the swagger route,
        server.go:420) — generated from the live route table so it can
        never drift from what is actually served."""
        return _json(openapi_document(routes, srv.version))

    add("GET", "/openapi.json", openapi)
    add("GET", "/healthz", healthz)
    add("GET", "/v1/components", list_components)
    add("DELETE", "/v1/components", deregister_component)
    add("GET", "/v1/components/trigger-check", trigger_check)
    # reference parity: a dedicated trigger-tag route exists alongside
    # trigger-check (pkg/server/handlers_components.go:20-31); both land
    # on the same handler here, which dispatches on the query params
    add("GET", "/v1/components/trigger-tag", trigger_check)
    add("POST", "/v1/components/set-healthy", set_healthy)
    add("GET", "/v1/states", states)
    add("GET", "/v1/states/history", states_history)
    add("GET", "/v1/predict/scores", predict_scores)
    add("GET", "/v1/predict/calibration", predict_calibration)
    add("GET", "/v1/fabric", fabric_matrix)
    add("GET", "/v1/remediation/audit", remediation_audit)
    add("GET", "/v1/remediation/policy", remediation_policy_get)
    add("POST", "/v1/remediation/policy", remediation_policy_post)
    add("POST", "/v1/chaos/run", chaos_run)
    add("GET", "/v1/chaos/campaigns", chaos_campaigns)
    add("GET", "/v1/session/status", session_status)
    add("GET", "/v1/events", events)
    add("GET", "/v1/metrics", metrics_v1)
    add("GET", "/v1/info", info)
    add("GET", "/v1/plugins", plugins)
    add("GET", "/v1/debug/traces", debug_traces)
    add("GET", "/metrics", prometheus)
    add("GET", "/machine-info", machine_info_handler)
    add("POST", "/inject-fault", inject_fault)
    add("GET", "/admin/config", admin_config)
    add("GET", "/admin/packages", admin_packages)
    return routes


def openapi_document(routes: List[Route], version: str) -> dict:
    """The OpenAPI 3 document of ``routes`` (every route but
    ``/openapi.json`` itself), paths sorted, as app.py:612-641 builds it
    from aiohttp's router."""
    paths: dict = {}
    for r in routes:
        if r.path == "/openapi.json":
            continue
        paths.setdefault(r.path, {})[r.method.lower()] = {
            "summary": r.summary,
            "responses": {"200": {"description": "OK"}},
        }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "tpud local API",
            "version": version,
            "description": "GPU fleet-health daemon node API",
        },
        "paths": dict(sorted(paths.items())),
    }


class App:
    """Dispatch over the route table, with the reference's middleware:
    latency and count by route template and method (unmatched paths and
    wrong methods collapse into one ``unmatched`` label, so a probe mints
    no series) and one ``http.request`` trace record per request. The
    daemon's table is ``build_routes(srv)``; ``routes`` serves another,
    and ``observe=False`` leaves the middleware out, as an aiohttp app
    built without it."""

    def __init__(self, srv: Optional["Server"] = None, *,
                 routes: Optional[List[Route]] = None, observe: bool = True) -> None:
        self.routes = build_routes(srv) if routes is None else list(routes)
        self.observe = observe
        # the middleware's families exist in a process that serves with it
        # (the daemon's), and in no other (the manager's, as the reference's)
        if observe:
            self._h_http = histogram(*HTTP_DURATION)
            self._c_http = counter(*HTTP_REQUESTS)
        self._by_path: Dict[str, Dict[str, Route]] = {}
        for r in self.routes:
            self._by_path.setdefault(r.path, {})[r.method] = r
        # dynamic paths, tried in registration order after the plain ones
        self._templates = [(_template(p), p) for p in self._by_path if "{" in p]

    def _match(self, path: str):
        if "{" not in path and path in self._by_path:
            return self._by_path[path], {}
        for pattern, template in self._templates:
            m = pattern.match(path)
            if m is not None:
                return self._by_path[template], m.groupdict()
        return None, {}

    def resolve(self, method: str, path: str):
        """(route, None, the path's {name} segments) for a match, else
        (None, the error response, {})."""
        methods, match_info = self._match(path)
        if methods is None:
            return None, _text("404: Not Found", 404), {}
        route = methods.get("GET" if method == "HEAD" else method)
        if route is None:
            allowed = set(methods) | ({"HEAD"} if "GET" in methods else set())
            resp = _text("405: Method Not Allowed", 405)
            resp.headers["Allow"] = ",".join(sorted(allowed))
            return None, resp, {}
        return route, None, match_info

    def handle(self, req: Request) -> Response:
        t0 = time.monotonic()
        start_unix = time.time()
        route, resp, req.match_info = self.resolve(req.method, req.path)
        label = route.path if route is not None else UNMATCHED
        try:
            if route is not None:
                try:
                    resp = route.handler(req)
                except HTTPError as e:
                    resp = e.response
                except Exception:  # noqa: BLE001 — aiohttp's 500, logged
                    logger.exception("handler for %s %s failed", req.method, req.path)
                    resp = _text("500 Internal Server Error\n\n"
                                 "Server got itself in trouble", 500)
            return resp
        finally:
            if self.observe:
                self._observe(req, label, resp, t0, start_unix)

    def _observe(self, req: Request, label: str, resp: Optional[Response], t0: float,
                 start_unix: float) -> None:
        status = resp.status if resp is not None else 500
        duration = time.monotonic() - t0
        self._h_http.observe(duration, {"route": label, "method": req.method})
        self._c_http.inc(labels={"route": label, "method": req.method, "status": str(status)})
        # flat record (not the thread-local span stack): the trace
        # ring's reader pairs nothing across requests
        DEFAULT_TRACER.record(
            "http.request",
            duration,
            component="http",
            start_unix=start_unix,
            status="ok" if status < 500 else "error",
            attrs={"route": label, "method": req.method, "status": status},
        )


SELF_COMPONENT = "tpud-self"


def _session_degraded(srv: "Server") -> bool:
    """True when a control-plane session exists but delivery is impaired:
    disconnected, parked on an auth failure, or circuit not closed. New
    records still land in the outbox journal, so nothing is lost — but
    the manager's view of this node is stale until the path recovers."""
    session = srv.session
    if session is None:
        return False
    if not session.connected or session.auth_failed:
        return True
    circuit = getattr(srv, "session_circuit", None)
    from gpud_tpu_torch.session.outbox import CIRCUIT_CLOSED

    return circuit is not None and circuit.state != CIRCUIT_CLOSED


def _self_info_entry(srv: "Server", start: float, now: float) -> dict:
    """Daemon self-observability summary for /v1/info: trace-ring stats and
    sqlite op totals, flattened to the ComponentInfo shape (extra_info is a
    string map on the wire)."""
    from gpud_tpu_torch import sqlite as sqlite_mod

    tstats = srv.tracer.stats()
    extra = {
        "trace_ring_capacity": str(tstats["capacity"]),
        "trace_ring_size": str(tstats["size"]),
        "trace_spans_recorded_total": str(tstats["recorded_total"]),
        "trace_spans_dropped_total": str(tstats["dropped_total"]),
    }
    slowest = tstats.get("slowest")
    if slowest:
        extra["trace_slowest_name"] = slowest["name"]
        extra["trace_slowest_duration_seconds"] = f"{slowest['duration_seconds']:.6f}"
    for k, v in sqlite_mod.stats().items():
        extra[f"sqlite_{k}"] = f"{v:.6f}" if isinstance(v, float) else str(v)
    ledger = getattr(srv, "health_ledger", None)
    if ledger is not None:
        summary = ledger.summary()
        extra["health_transitions_total"] = str(summary["transitions_total"])
        extra["health_components_tracked"] = str(summary["components_tracked"])
        extra["health_flapping_components"] = ",".join(summary["flapping"])
    # SessionDegraded: the manager-facing warning flag — set whenever a
    # configured control-plane session cannot currently deliver (records
    # keep journaling to the outbox; nothing is lost, only delayed)
    if srv.session is not None:
        extra["SessionDegraded"] = str(_session_degraded(srv)).lower()
        circuit = getattr(srv, "session_circuit", None)
        if circuit is not None:
            extra["session_circuit_state"] = circuit.state
    outbox = getattr(srv, "outbox", None)
    if outbox is not None:
        extra["outbox_backlog"] = str(outbox.stats()["backlog"])
    return ComponentInfo(
        component=SELF_COMPONENT,
        start_time=start,
        end_time=now,
        states=[
            HealthState(
                time=now,
                component=SELF_COMPONENT,
                name=SELF_COMPONENT,
                reason="daemon self-observability summary",
                extra_info=extra,
            )
        ],
        events=[],
        metrics=[],
    ).to_dict()

