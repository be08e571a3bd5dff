"""Typed HTTP client for the tpud local API; the port of
``gpud_tpu/client/v1.py`` on the standard library (``http.client``).

Reference: client/v1/v1.go:23-543 — GetComponents/GetInfo/GetHealthStates/
GetEvents/GetMetrics/Deregister/SetHealthy/TriggerCheck; used by the CLI
subcommands and the e2e suite.

The reference package's client rides ``requests``; a host may lack it. This
one keeps one keep-alive connection per client (reopened once when the
server closed an idle one), sends ``params`` as the query string and
``body`` as JSON, and raises ``ClientError`` with the status and the body's
text on any answer of 400 or more; a transport failure raises ``OSError``.
Certificates are not verified: the local API's is self-signed by design
(reference: server.go:507).
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Dict, List, Optional
from urllib.parse import urlencode, urlsplit

from gpud_tpu_torch.api.v1.types import (
    ComponentEvents,
    ComponentHealthStates,
    ComponentInfo,
    ComponentMetrics,
    MachineInfo,
)

DEFAULT_TIMEOUT = 30.0


class ClientError(Exception):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"HTTP {status}: {body[:200]}")
        self.status = status
        self.body = body


def _unverified_context():
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


class Client:
    def __init__(
        self,
        base_url: str = "https://localhost:15132",
        timeout: float = DEFAULT_TIMEOUT,
        admin_token: str = "",
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        u = urlsplit(self.base_url)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise ValueError(f"invalid base URL {base_url!r}")
        self._scheme, self._host = u.scheme, u.hostname
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._prefix = u.path
        self.headers: Dict[str, str] = {}
        if admin_token:
            # manager operator endpoints (fleet rollup/history/traces)
            # require the admin bearer when the manager is started with one
            self.headers["Authorization"] = f"Bearer {admin_token}"
        self._conn: Optional[http.client.HTTPConnection] = None
        self._mu = threading.Lock()

    # -- plumbing ----------------------------------------------------------
    def _connect(self) -> http.client.HTTPConnection:
        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self.timeout, context=_unverified_context())
        return http.client.HTTPConnection(self._host, self._port, timeout=self.timeout)

    def close(self) -> None:
        with self._mu:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _send(self, method: str, url: str, data: Optional[bytes], headers: Dict[str, str]):
        """One request on the kept connection (opened if there is none);
        the connection is dropped on any failure and when the server
        closes it."""
        if self._conn is None:
            self._conn = self._connect()
        try:
            self._conn.request(method, url, body=data, headers=headers)
            resp = self._conn.getresponse()
            raw = resp.read()
        except BaseException:
            self._conn.close()
            self._conn = None
            raise
        if resp.will_close:
            self._conn.close()
            self._conn = None
        return resp, raw

    def _exchange(self, method: str, url: str, data: Optional[bytes], headers: Dict[str, str]):
        """``_send``, once more on a fresh connection when a kept one turns
        out closed by the server while idle."""
        reused = self._conn is not None
        try:
            return self._send(method, url, data, headers)
        except (http.client.RemoteDisconnected, ConnectionResetError, BrokenPipeError):
            if not reused:
                raise
            return self._send(method, url, data, headers)

    def _req(self, method: str, path: str, params=None, body=None):
        url = self._prefix + path
        if params:
            url += "?" + urlencode({k: v for k, v in params.items() if v is not None})
        headers = dict(self.headers)
        data = None
        if body is not None:
            data = json.dumps(body).encode("utf-8")
            headers["Content-Type"] = "application/json"
        with self._mu:
            resp, raw = self._exchange(method, url, data, headers)
        ctype = resp.getheader("Content-Type", "")
        charset = "utf-8"
        for part in ctype.split(";")[1:]:
            k, _, v = part.strip().partition("=")
            if k.lower() == "charset" and v:
                charset = v.strip('"')
        text = raw.decode(charset, "replace")
        if resp.status >= 400:
            raise ClientError(resp.status, text)
        if "json" in ctype:
            return json.loads(text)
        return text

    # -- API (reference: client/v1/v1.go) ---------------------------------
    def healthz(self) -> Dict:
        return self._req("GET", "/healthz")

    def get_components(self) -> List[str]:
        return self._req("GET", "/v1/components")

    def deregister_component(self, name: str) -> Dict:
        return self._req("DELETE", "/v1/components", params={"componentName": name})

    def trigger_check(self, component: str = "", tag: str = "") -> List[ComponentHealthStates]:
        params = {}
        if component:
            params["componentName"] = component
        if tag:
            params["tagName"] = tag
        data = self._req("GET", "/v1/components/trigger-check", params=params)
        return [ComponentHealthStates.from_dict(d) for d in data]

    def set_healthy(self, component: str) -> Dict:
        return self._req(
            "POST", "/v1/components/set-healthy", params={"componentName": component}
        )

    def get_health_states(
        self, components: Optional[List[str]] = None
    ) -> List[ComponentHealthStates]:
        params = {"components": ",".join(components)} if components else None
        data = self._req("GET", "/v1/states", params=params)
        return [ComponentHealthStates.from_dict(d) for d in data]

    def get_events(
        self,
        start_time: Optional[float] = None,
        end_time: Optional[float] = None,
        components: Optional[List[str]] = None,
    ) -> List[ComponentEvents]:
        params = {}
        if start_time is not None:
            params["startTime"] = start_time
        if end_time is not None:
            params["endTime"] = end_time
        if components:
            params["components"] = ",".join(components)
        data = self._req("GET", "/v1/events", params=params or None)
        return [ComponentEvents.from_dict(d) for d in data]

    def get_metrics(
        self,
        since: Optional[float] = None,
        components: Optional[List[str]] = None,
    ) -> List[ComponentMetrics]:
        params = {}
        if since is not None:
            params["since"] = since
        if components:
            params["components"] = ",".join(components)
        data = self._req("GET", "/v1/metrics", params=params or None)
        return [ComponentMetrics.from_dict(d) for d in data]

    def get_state_history(
        self,
        component: str = "",
        since: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> Dict:
        """Persisted health-transition timeline (``/v1/states/history``):
        ``{"transitions": [...], "count": n, "flapping": [...]}`` plus an
        ``availability`` block when a single component is requested."""
        params: Dict = {}
        if component:
            params["component"] = component
        if since is not None:
            params["since"] = since
        if limit is not None:
            params["limit"] = limit
        return self._req("GET", "/v1/states/history", params=params or None)

    def get_remediation_audit(
        self,
        component: str = "",
        action: str = "",
        outcome: str = "",
        since: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> Dict:
        """Remediation audit ledger (``/v1/remediation/audit``):
        ``{"attempts": [...], "count": n, "status": {...}}``."""
        params: Dict = {}
        for k, v in (
            ("component", component), ("action", action), ("outcome", outcome)
        ):
            if v:
                params[k] = v
        if since is not None:
            params["since"] = since
        if limit is not None:
            params["limit"] = limit
        return self._req("GET", "/v1/remediation/audit", params=params or None)

    def get_predict_scores(
        self,
        component: str = "",
        history: Optional[int] = None,
    ) -> Dict:
        """Precursor scores (``/v1/predict/scores``): per-component fused
        score, feature breakdown, armed/warned state, and measured lead
        times; ``history=N`` appends the last N in-memory score points
        per component."""
        params: Dict = {}
        if component:
            params["component"] = component
        if history is not None:
            params["history"] = history
        return self._req("GET", "/v1/predict/scores", params=params or None)

    def get_predict_calibration(self, refit: bool = False) -> Dict:
        """Learned-threshold calibration state
        (``/v1/predict/calibration``): per-component-class fitted
        thresholds and feature weights replayed from the node's own
        ledger history; ``refit=True`` re-fits synchronously before
        returning."""
        params: Dict = {}
        if refit:
            params["refit"] = 1
        return self._req(
            "GET", "/v1/predict/calibration", params=params or None,
        )

    def get_fabric(
        self,
        link: str = "",
        since: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> Dict:
        """Fabric matrix (``GET /v1/fabric``): discovered mesh, sweep
        status, and the current per-link (src, dst, axis, latency,
        state) matrix; any of ``link``/``since``/``limit`` appends
        matrix history rows from the durable store."""
        params: Dict = {}
        if link:
            params["link"] = link
        if since is not None:
            params["since"] = since
        if limit is not None:
            params["limit"] = limit
        return self._req("GET", "/v1/fabric", params=params or None)

    def get_remediation_policy(self) -> Dict:
        """Current remediation policy + guard state."""
        return self._req("GET", "/v1/remediation/policy")

    def set_remediation_policy(self, policy: Dict) -> Dict:
        """Partial policy update (``POST /v1/remediation/policy``) — e.g.
        ``{"enforce_actions": ["restart_runtime"]}`` graduates an action
        out of dry-run."""
        return self._req("POST", "/v1/remediation/policy", body=policy)

    def get_info(self, components: Optional[List[str]] = None) -> List[ComponentInfo]:
        params = {"components": ",".join(components)} if components else None
        data = self._req("GET", "/v1/info", params=params)
        return [ComponentInfo.from_dict(d) for d in data]

    def get_machine_info(self) -> MachineInfo:
        return MachineInfo.from_dict(self._req("GET", "/machine-info"))

    def get_prometheus_metrics(self) -> str:
        return self._req("GET", "/metrics")

    def inject_fault(
        self,
        gpu_error_name: str = "",
        gpu_id: int = 0,
        detail: str = "",
        kernel_message: str = "",
        repeat: int = 1,
        interval_seconds: float = 0.0,
    ) -> Dict:
        """One kmsg fault write — or a burst/flap of ``repeat`` writes
        spaced ``interval_seconds`` apart. Returns the structured
        injection result (line, writes, timestamp)."""
        return self._req(
            "POST",
            "/inject-fault",
            body={
                "gpu_error_name": gpu_error_name,
                "gpu_id": gpu_id,
                "detail": detail,
                "kernel_message": kernel_message,
                "repeat": repeat,
                "interval_seconds": interval_seconds,
            },
        )

    def run_chaos(self, scenario, wait: bool = True) -> Dict:
        """Run a chaos campaign (``POST /v1/chaos/run``). ``scenario`` is
        a shipped scenario name, a file path on the daemon host, or an
        inline scenario mapping; ``wait=False`` launches it and returns
        the running-campaign status immediately."""
        return self._req(
            "POST", "/v1/chaos/run", body={"scenario": scenario, "wait": wait}
        )

    def get_chaos_campaigns(self, limit: Optional[int] = None) -> Dict:
        """Chaos campaign history + available scenarios
        (``/v1/chaos/campaigns``)."""
        params = {"limit": limit} if limit is not None else None
        return self._req("GET", "/v1/chaos/campaigns", params=params)

    def get_session_status(self) -> Dict:
        """Control-plane session health (``/v1/session/status``):
        connection + auth state, circuit breaker, and the
        store-and-forward outbox backlog/watermark."""
        return self._req("GET", "/v1/session/status")

    # -- fleet observability (manager operator API) ------------------------
    # These speak to a *manager* (the reference's manager/control_plane.py),
    # not an agent: construct the Client with the manager's endpoint as
    # base_url (and admin_token when the manager enforces one).

    def get_fleet_rollup(self) -> Dict:
        """Fleet-wide rollup aggregates (``GET /v1/fleet/rollup``):
        availability, MTTR/MTBF, flap leaders, per-kind record counts."""
        return self._req("GET", "/v1/fleet/rollup")

    def get_fleet_fabric(self, since: Optional[float] = None) -> Dict:
        """Fleet-wide NVLink fabric rollup (``GET /v1/fleet/fabric``):
        per-agent link aggregates — which links degraded since ``since``
        across every agent, from one query."""
        params: Dict = {}
        if since is not None:
            params["since"] = since
        return self._req("GET", "/v1/fleet/fabric", params=params or None)

    def get_fleet_predict(self, top: Optional[int] = None) -> Dict:
        """Fleet-ranked predictive pane (``GET /v1/fleet/predict``):
        the top-K (agent, component) series by time-decayed predicted-
        failure risk, with lead-time distribution and risk buckets."""
        params: Dict = {}
        if top is not None:
            params["top"] = top
        return self._req("GET", "/v1/fleet/predict", params=params or None)

    def get_fleet_agents(self, offset: int = 0, limit: int = 100) -> Dict:
        """One paginated page of per-agent rollups
        (``GET /v1/fleet/agents``); ``next_offset`` is None on the last
        page."""
        return self._req(
            "GET", "/v1/fleet/agents",
            params={"offset": offset, "limit": limit},
        )

    def get_fleet_history(
        self,
        agent_id: str,
        since: Optional[float] = None,
        limit: Optional[int] = None,
        offset: Optional[int] = None,
    ) -> Dict:
        """One agent's journaled record history, newest first
        (``GET /v1/fleet/agents/{id}/history``)."""
        params = {}
        if since is not None:
            params["since"] = since
        if limit is not None:
            params["limit"] = limit
        if offset is not None:
            params["offset"] = offset
        return self._req(
            "GET", f"/v1/fleet/agents/{agent_id}/history",
            params=params or None,
        )

    def get_fleet_traces(self, correlation_id: str) -> Dict:
        """Every fleet record stitched to one agent-side check trace
        (``GET /v1/fleet/traces?correlation_id=``)."""
        return self._req(
            "GET", "/v1/fleet/traces",
            params={"correlation_id": correlation_id},
        )

    def get_fleet_peers(self) -> Dict:
        """The manager peer map (``GET /v1/fleet/peers``): ring order,
        per-peer health, rendezvous cohort counts, and replication
        watermarks; ``{"federation": false, ...}`` from a standalone
        manager."""
        return self._req("GET", "/v1/fleet/peers")
