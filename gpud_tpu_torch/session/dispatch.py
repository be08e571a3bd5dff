"""Control-plane request dispatch.

Reference: pkg/session/session_process_request.go:24-157 — the method set a
session must answer: reboot | metrics | states | events | delete | logout |
setHealthy | gossip | packageStatus | update | updateConfig | bootstrap |
injectFault | triggerComponent | deregisterComponent | setPluginSpecs |
getPluginSpecs | updateToken | getToken.

Requests arrive as ``{"method": "...", ...params}``; responses are plain
dicts. Slow operations (gossip: NFS can hang; triggerComponent: slow
checks) run asynchronously and return immediately (reference rationale:
session_process_request.go:64-84, 108-125).

The port of ``gpud_tpu/session/dispatch.py``: it serves the port's
``Daemon`` where the reference serves ``Server``, and speaks the port's
nouns where a request names the accelerator: ``injectFault`` takes
``gpu_error_name`` and ``gpu_id``, ``updateConfig`` takes
``expected_gpu_count`` and an ``nvlink`` section (for the
``accelerator-gpu-nvlink`` check) where the reference takes
``expected_chip_count`` and ``ici``, and ``error_thresholds`` names the GPU
catalog's entries. ``chaosRun`` and ``chaosStatus`` drive the daemon's
chaos campaign runner (``gpud_tpu_torch/chaos/``).
"""

from __future__ import annotations

import base64
import threading
import time
from typing import TYPE_CHECKING, Callable, Dict

from gpud_tpu_torch import host as pkghost
from gpud_tpu_torch import machine_info as machineinfo
from gpud_tpu_torch.fault_injector import Request as InjectRequest
from gpud_tpu_torch.log import audit, get_logger
from gpud_tpu_torch.metadata import KEY_TOKEN
from gpud_tpu_torch.metrics.registry import counter, histogram
from gpud_tpu_torch.process import run_bash_script
from gpud_tpu_torch.tracing import DEFAULT_TRACER

if TYPE_CHECKING:
    from gpud_tpu_torch.daemon import Daemon

logger = get_logger(__name__)

# session dispatch latency: the serve loop is single-threaded per session,
# so one slow handler delays every queued control-plane request behind it
_h_dispatch = histogram(
    "tpud_session_dispatch_duration_seconds",
    "control-plane session request dispatch latency by method",
)
_c_dispatch = counter(
    "tpud_session_dispatch_total",
    "control-plane session dispatches by method and outcome (ok|error)",
)

DEFAULT_BOOTSTRAP_TIMEOUT = 10 * 60.0
# exit code asking the supervisor (systemd/DaemonSet) to restart us with
# new plugin specs (reference: session_process_request.go:137-141)
RESTART_EXIT_CODE = 245
# a finished diagnostic bundle answers matching re-polls for this long;
# far above the CP poll cadence (so a script runs once per request) but
# bounded so a later identical request gets fresh data
DIAGNOSTIC_CACHE_SECONDS = 300.0


class Dispatcher:
    def __init__(self, server: "Daemon") -> None:
        self.server = server
        self.reboot_fn: Callable = pkghost.reboot
        # restart-by-exit-code: the supervisor (systemd Restart=always,
        # SuccessExitStatus=244 245) brings us back with the new specs
        import os as _os

        self.exit_fn: Callable[[int], None] = _os._exit  # noqa: SLF001
        self._gossip_inflight = threading.Event()
        self._diagnostic_inflight = threading.Event()
        # injectFault rate limit — reuses the remediation token bucket
        # with its own capacity/refill knobs (config inject_rate_*)
        from gpud_tpu_torch.remediation.policy import Policy as _BucketPolicy
        from gpud_tpu_torch.remediation.policy import TokenBucket

        cfg = getattr(server, "config", None)
        self.time_now_fn: Callable[[], float] = time.time
        self._inject_bucket = TokenBucket(
            _BucketPolicy(
                rate_capacity=int(getattr(cfg, "inject_rate_capacity", 10)),
                rate_refill_seconds=float(
                    getattr(cfg, "inject_rate_refill_seconds", 6.0)
                ),
            )
        )

    def _spawn(self, name: str, fn: Callable[[], None]) -> None:
        """Async session work (gossip/diagnostic can hang on NFS stat)
        runs as a one-shot on the unified scheduler pool — the watchdog
        reclaims a wedged slot and ad-hoc threads stop accumulating. A
        scheduler-less server (older tests) falls back to a thread."""
        scheduler = getattr(self.server, "scheduler", None)
        if scheduler is not None and scheduler.submit(f"session:{name}", fn):
            return
        threading.Thread(target=fn, name=f"tpud-{name}", daemon=True).start()

    def __call__(self, req: Dict) -> Dict:
        if not isinstance(req, dict):
            return {"error": "request must be an object"}
        method = req.get("method", "")
        if not isinstance(method, str):
            return {"error": f"invalid method {method!r}"}
        handler = getattr(self, f"_m_{method.replace('-', '_')}", None)
        if handler is None:
            # the method name comes off the wire: label with a sentinel, not
            # the raw string, or a hostile peer mints unbounded label sets
            _c_dispatch.inc(labels={"method": "<unknown>", "outcome": "error"})
            return {"error": f"unknown method {method!r}"}
        audit("session_request", method=method)
        outcome = "ok"
        t0 = time.monotonic()
        try:
            with DEFAULT_TRACER.span(
                "session.dispatch", component="session", attrs={"method": method}
            ):
                resp = handler(req)
            if isinstance(resp, dict) and "error" in resp:
                outcome = "error"
            return resp
        except Exception as e:  # noqa: BLE001
            outcome = "error"
            logger.exception("session method %s failed", method)
            return {"error": str(e)}
        finally:
            _h_dispatch.observe(time.monotonic() - t0, {"method": method})
            _c_dispatch.inc(labels={"method": method, "outcome": outcome})

    # -- state/introspection ----------------------------------------------
    def _m_states(self, req: Dict) -> Dict:
        comps = req.get("components") or None
        out = []
        for c in self.server.registry.all():
            if comps and c.name() not in comps:
                continue
            if not comps and c.name() not in self.server.supported_names:
                continue
            out.append(
                {
                    "component": c.name(),
                    "states": [s.to_dict() for s in c.last_health_states()],
                }
            )
        return {"states": out}

    def _m_events(self, req: Dict) -> Dict:
        since = float(req.get("since", time.time() - 3 * 3600))
        out = []
        for c in self.server.registry.all():
            evs = c.events(since)
            out.append(
                {"component": c.name(), "events": [e.to_dict() for e in evs]}
            )
        return {"events": out}

    def _m_stateHistory(self, req: Dict) -> Dict:
        """Persisted health-transition timeline from the ledger, with
        eventstore correlation — the control-plane view of what the HTTP
        route ``/v1/states/history`` serves locally."""
        ledger = self.server.health_ledger
        component = req.get("component", "") or None
        since = float(req.get("since", time.time() - 24 * 3600))
        limit = int(req.get("limit", 256))
        transitions = ledger.history(component=component, since=since, limit=limit)
        ledger.annotate_with_events(transitions)
        out: Dict = {
            "history": transitions,
            "count": len(transitions),
            "flapping": ledger.flapping_components(),
        }
        if component:
            av = ledger.availability(component)
            if av is not None:
                out["availability"] = av
        return out

    def _m_predictStatus(self, req: Dict) -> Dict:
        """Predict engine rollup for the control plane: config + run
        state plus per-component precursor scores (``component`` narrows,
        ``history`` appends bounded score history) — the session twin of
        ``GET /v1/predict/scores``."""
        eng = getattr(self.server, "predictor", None)
        if eng is None:
            return {"error": "predict engine disabled"}
        component = req.get("component", "")
        history = int(req.get("history", 0))
        out = eng.scores(
            component=component, history_limit=max(0, history)
        )
        out["status"] = eng.status()
        return out

    def _m_predictCalibration(self, req: Dict) -> Dict:
        """Threshold-calibration state for the control plane: per-class
        fitted thresholds/weights replayed from the node's own ledger
        history (``refit`` re-fits synchronously first) — the session
        twin of ``GET /v1/predict/calibration``."""
        eng = getattr(self.server, "predictor", None)
        if eng is None:
            return {"error": "predict engine disabled"}
        if bool(req.get("refit")):
            eng.calibrate_now()
        return eng.calibration()

    def _m_fabricStatus(self, req: Dict) -> Dict:
        """Fabric plane rollup for the control plane: discovered mesh +
        sweep state + the current per-link matrix (``link``/``since``/
        ``limit`` append matrix history) — the session twin of
        ``GET /v1/fabric``."""
        plane = getattr(self.server, "fabric", None)
        if plane is None:
            return {"error": "fabric plane disabled"}
        link = str(req.get("link", "") or "")
        since = float(req.get("since", 0.0))
        limit = int(req.get("limit", 0))
        out = {"status": plane.status(), "matrix": plane.matrix()}
        if link or since > 0 or limit > 0:
            out["history"] = plane.history(
                link=link, since=since, limit=limit if limit > 0 else 256
            )
        return out

    def _m_remediationStatus(self, req: Dict) -> Dict:
        """Remediation engine rollup for the control plane: policy + guard
        state plus the most recent audit rows (``limit``, ``since``,
        ``component`` filters mirror ``GET /v1/remediation/audit``)."""
        eng = getattr(self.server, "remediation", None)
        if eng is None:
            return {"error": "remediation engine disabled"}
        limit = int(req.get("limit", 32))
        since = float(req.get("since", 0.0))
        component = req.get("component", "") or None
        attempts = eng.audit.read(
            component=component, since=since, limit=limit
        )
        return {
            "remediation": eng.status(),
            "attempts": attempts,
            "count": len(attempts),
        }

    def _m_remediationPolicy(self, req: Dict) -> Dict:
        """Runtime remediation-policy push (same field-by-field contract
        as updateConfig: one invalid key must not block the rest)."""
        eng = getattr(self.server, "remediation", None)
        if eng is None:
            return {"error": "remediation engine disabled"}
        updated, errors = eng.policy.update(req.get("policy", {}))
        if updated:
            audit("remediation_policy_update", updated=",".join(updated))
        out: Dict = {"status": "ok", "updated": updated}
        if errors:
            out["errors"] = errors
        return out

    def _m_metrics(self, req: Dict) -> Dict:
        since = float(req.get("since", time.time() - 3 * 3600))
        ms = self.server.metrics_store.read(since)
        return {"metrics": [m.to_dict() for m in ms]}

    def _m_traces(self, req: Dict) -> Dict:
        """Trace-ring snapshot for the control plane — the session twin
        of ``GET /v1/debug/traces``. The manager uses the
        ``correlation_id`` filter to fetch the live agent-side spans
        behind a fleet record (docs/fleet.md)."""
        tracer = self.server.tracer
        spans = tracer.snapshot(
            component=req.get("component", "") or None,
            limit=int(req.get("limit", 64)),
            since=float(req.get("since", 0.0)),
            correlation_id=req.get("correlation_id", "") or None,
        )
        return {"spans": spans, "stats": tracer.stats()}

    def _m_gossip(self, req: Dict) -> Dict:
        # async: machine info can hang on NFS stat (reference:
        # session_process_request.go:64-84) — compute in a thread and
        # return immediately; the control plane polls again
        result: Dict = {"status": "started"}

        def work():
            try:
                mi = machineinfo.get_machine_info(
                    gpu=self.server.gpu_instance,
                    machine_id=self.server.machine_id,
                )
                self.server.last_gossip = mi.to_dict()
                # journal a compact gossip marker into the durable outbox
                # (the full tree is poll-on-demand; what must survive a
                # partition is that this node gossiped, and when)
                outbox = getattr(self.server, "outbox", None)
                if outbox is not None:
                    outbox.publish(
                        "gossip",
                        {
                            "machine_id": self.server.machine_id,
                            "ts": time.time(),
                        },
                    )
            except Exception:  # noqa: BLE001
                logger.exception("gossip failed")
            finally:
                self._gossip_inflight.clear()

        # in-flight guard: when machine-info hangs (NFS stat), re-polls
        # must not stack additional stuck threads
        if not self._gossip_inflight.is_set():
            self._gossip_inflight.set()
            self._spawn("gossip", work)
        if getattr(self.server, "last_gossip", None):
            result["machine_info"] = self.server.last_gossip
            result["status"] = "ok"
        return result

    @staticmethod
    def _decode_script(b64: str):
        """Shared base64-script decode → (script, error) (bootstrap +
        diagnostic use the same contract)."""
        try:
            script = base64.b64decode(b64, validate=True).decode("utf-8")
        except Exception:  # noqa: BLE001
            return "", "invalid base64 script"
        if not script.strip():
            return "", "empty script"
        return script, None

    @staticmethod
    def _script_result(r) -> Dict:
        return {"exit_code": r.exit_code, "output": r.output[-4096:], "error": r.error}

    def _m_diagnostic(self, req: Dict) -> Dict:
        """Diagnostic bundle: states + recent events + machine info, plus an
        optional base64 diagnostic script (reference:
        session_process_request.go:104). Async like gossip — collection can
        hang on NFS stat or a slow script, so the serve loop returns
        immediately and the control plane re-polls for the finished bundle.

        Scripted requests are answered only by a bundle produced for the
        SAME script (matched on the base64), and a finished bundle is not
        re-collected by the completion poll — a non-idempotent diagnostic
        script must run exactly once per request."""
        b64 = req.get("script_base64", "")
        script = ""
        if b64:
            script, err = self._decode_script(b64)
            if err:
                return {"error": err}
        since = float(req.get("since", time.time() - 3 * 3600))
        timeout = float(req.get("timeout_seconds", DEFAULT_BOOTSTRAP_TIMEOUT))

        last = getattr(self.server, "last_diagnostic", None)
        if (
            last
            and last.get("script_b64", "") == b64
            and time.time() - last.get("collected_at", 0) < DIAGNOSTIC_CACHE_SECONDS
        ):
            # this exact request already has a fresh finished bundle; a
            # repeat request after the cache window re-collects (and
            # re-runs the script — that recurrence is a new intent)
            return {"status": "ok", "diagnostic": last}
        if self._diagnostic_inflight.is_set():
            return {"status": "busy" if script else "started"}

        def work():
            try:
                bundle: Dict = {"collected_at": time.time(), "script_b64": b64}
                bundle["states"] = self._m_states({})["states"]
                bundle["events"] = self._m_events({"since": since})["events"]
                try:
                    mi = machineinfo.get_machine_info(
                        gpu=self.server.gpu_instance,
                        machine_id=self.server.machine_id,
                    )
                    bundle["machine_info"] = mi.to_dict()
                except Exception as e:  # noqa: BLE001
                    bundle["machine_info_error"] = str(e)
                if script:
                    audit("diagnostic_script", length=len(script))
                    bundle["script"] = self._script_result(
                        run_bash_script(script, timeout=timeout)
                    )
                self.server.last_diagnostic = bundle
            except Exception:  # noqa: BLE001
                logger.exception("diagnostic bundle failed")
            finally:
                self._diagnostic_inflight.clear()

        self._diagnostic_inflight.set()
        self._spawn("diagnostic", work)
        return {"status": "started"}

    # -- actions -----------------------------------------------------------
    def _m_reboot(self, req: Dict) -> Dict:
        delay = float(req.get("delay_seconds", 0))
        audit("session_reboot", delay=delay)

        def work():
            if delay:
                time.sleep(delay)
            err = self.reboot_fn()
            if err:
                logger.error("reboot failed: %s", err)

        # NOT pooled: a delayed reboot sleeping on a worker would idle a
        # pool slot for the whole delay
        threading.Thread(target=work, name="tpud-reboot", daemon=True).start()
        return {"status": "rebooting"}

    def _m_setHealthy(self, req: Dict) -> Dict:
        name = req.get("component", "")
        c = self.server.registry.get(name)
        if c is None:
            return {"error": f"component {name!r} not found"}
        fn = getattr(c, "set_healthy", None)
        if fn is None:
            return {"error": f"component {name!r} is not health-settable"}
        fn()
        return {"status": "ok"}

    def _m_triggerComponent(self, req: Dict) -> Dict:
        # async: checks can be slow (reference: 108-125)
        name = req.get("component", "")
        tag = req.get("tag", "")
        comps = []
        if name:
            c = self.server.registry.get(name)
            if c is None:
                return {"error": f"component {name!r} not found"}
            comps = [c]
        elif tag:
            comps = [c for c in self.server.registry.all() if tag in c.tags()]
        for c in comps:
            # a scheduler-driven poller is poked to the front of the heap
            # (keeps the no-overlapping-runs invariant); anything else
            # gets a one-shot on the pool
            job = getattr(c, "_job", None)
            if job is not None:
                job.poke()
            else:
                self._spawn(f"trigger:{c.name()}", c.check)
        return {"status": "triggered", "components": [c.name() for c in comps]}

    def _m_deregisterComponent(self, req: Dict) -> Dict:
        name = req.get("component", "")
        c = self.server.registry.get(name)
        if c is None:
            return {"error": f"component {name!r} not found"}
        if not c.can_deregister():
            return {"error": f"component {name!r} is not deregisterable"}
        self.server.registry.deregister(name)
        c.close()
        return {"status": "ok"}

    def _m_injectFault(self, req: Dict) -> Dict:
        # token bucket: a hostile or buggy control plane must not be able
        # to spam kmsg writes through the session (burst requests already
        # multiply writes server-side via repeat)
        if not self._inject_bucket.take(self.time_now_fn()):
            return {
                "error": "fault injection rate limit exhausted",
                "retryable": True,
            }
        ir = InjectRequest.from_dict(req)
        res = self.server.fault_injector.inject(ir)
        out = res.to_dict()
        if res.ok:
            out["status"] = "ok"
        else:
            out["status"] = "error"
            out["error"] = res.error
        return out

    def _m_chaosRun(self, req: Dict) -> Dict:
        """Launch a chaos campaign (scenario name or inline mapping).
        Defaults to wait=false: the serve loop is single-threaded per
        session, so a campaign must not stall queued requests behind it."""
        chaos = getattr(self.server, "chaos", None)
        if chaos is None:
            return {"error": "chaos is disabled (chaos_enabled)"}
        out, err = chaos.run_campaign(
            req.get("scenario"), wait=bool(req.get("wait", False))
        )
        if err:
            return {"error": err}
        return out

    def _m_chaosStatus(self, req: Dict) -> Dict:
        chaos = getattr(self.server, "chaos", None)
        if chaos is None:
            return {"error": "chaos is disabled (chaos_enabled)"}
        limit = int(req.get("limit") or 0)
        return chaos.campaigns(limit=max(0, limit))

    # -- durable outbox (session/outbox.py) --------------------------------
    def _m_outboxAck(self, req: Dict) -> Dict:
        """Manager acks the outbox replay watermark: everything at/below
        ``seq`` was received (and deduped by key) on its side. Monotonic —
        a stale or replayed ack never regresses the watermark."""
        outbox = getattr(self.server, "outbox", None)
        if outbox is None:
            return {"error": "outbox is disabled (outbox_enabled)"}
        try:
            seq = int(req.get("seq"))
        except (TypeError, ValueError):
            return {"error": "outboxAck requires an integer 'seq'"}
        if seq < 0:
            return {"error": "outboxAck requires seq >= 0"}
        return {"acked_seq": outbox.ack(seq)}

    def _m_outboxStatus(self, req: Dict) -> Dict:
        """Outbox journal + circuit-breaker state (the session-method
        mirror of ``GET /v1/session/status``)."""
        outbox = getattr(self.server, "outbox", None)
        if outbox is None:
            return {"error": "outbox is disabled (outbox_enabled)"}
        out: Dict = {"outbox": outbox.stats()}
        circuit = getattr(self.server, "session_circuit", None)
        if circuit is not None:
            out["circuit"] = circuit.stats()
        # wire codec byte accounting (docs/session.md wire format)
        from gpud_tpu_torch.session import wire

        out["wire"] = wire.codec_stats()
        return out

    def _m_peerStatus(self, req: Dict) -> Dict:
        """Which manager this agent is parked on and how failover stands
        (docs/session.md "Peer failover"): the breaker's peer list,
        current index, and failover count, plus the session's active
        endpoint/transport."""
        out: Dict = {}
        circuit = getattr(self.server, "session_circuit", None)
        if circuit is not None:
            stats = circuit.stats()
            out["peers"] = stats["peers"]
            out["peer_index"] = stats["peer_index"]
            out["failovers"] = stats["failovers"]
            out["circuit_state"] = stats["state"]
        session = getattr(self.server, "session", None)
        if session is not None:
            out["endpoint"] = session.endpoint
            out["v2_target"] = session.v2_target
            out["connected"] = session.connected
            out["active_protocol"] = session.active_protocol
            out["reconnects"] = session.reconnect_count
        if not out:
            return {"error": "no session or circuit configured"}
        return out

    def _m_bootstrap(self, req: Dict) -> Dict:
        """base64 script exec (reference: session bootstrap)."""
        script, err = self._decode_script(req.get("script_base64", ""))
        if err:
            return {"error": err}
        timeout = float(req.get("timeout_seconds", DEFAULT_BOOTSTRAP_TIMEOUT))
        audit("bootstrap_script", length=len(script))
        return self._script_result(run_bash_script(script, timeout=timeout))

    # -- config/token ------------------------------------------------------
    def _m_updateConfig(self, req: Dict) -> Dict:
        """Runtime re-config pushed by the control plane (reference:
        session/update_config.go:19 → setters, session.go:222-227).
        Overrides are persisted to the metadata table and re-applied at
        boot (reference: cmd/gpud/run persistMetadataOverrides)."""
        cfgs = req.get("configs", {})
        updated, applied, errors = self.apply_config_overrides(cfgs)
        if applied:
            self._persist_config_overrides(applied)
        out: Dict = {"status": "ok", "updated": updated}
        if errors:
            out["errors"] = errors
        return out

    def _persist_config_overrides(self, applied: Dict) -> None:
        """Merge ONLY the successfully-applied subset into the persisted
        overrides — unknown or invalid keys must not be replayed forever."""
        import json as _json

        from gpud_tpu_torch.metadata import KEY_CONFIG_OVERRIDES

        existing = {}
        raw = self.server.metadata.get(KEY_CONFIG_OVERRIDES)
        if raw:
            try:
                loaded = _json.loads(raw)
                if isinstance(loaded, dict):
                    existing = loaded
            except ValueError:
                pass
        for k, v in applied.items():
            if isinstance(v, dict):
                prev = existing.get(k)
                merged = dict(prev) if isinstance(prev, dict) else {}
                merged.update(v)
                existing[k] = merged
            else:
                existing[k] = v
        self.server.metadata.set(KEY_CONFIG_OVERRIDES, _json.dumps(existing))

    def _apply_numeric_section(
        self,
        section: str,
        comp_name: str,
        cfgs: Dict,
        key_min: Dict[str, float],
        updated: list,
        applied: Dict,
        errors: list,
    ) -> None:
        """Shared coerce/validate/apply/record loop for a section of
        numeric component attributes. Values are coerced to the attribute's
        current type; `not >=` rejects NaN (json.loads accepts the NaN
        token) as well as below-minimum values; a valid push against a
        disabled component errors instead of vanishing silently."""
        cfg = cfgs.get(section)
        if cfg is None:
            return
        if not isinstance(cfg, dict):
            errors.append(f"{section}: must be an object")
            return
        comp = self.server.registry.get(comp_name)
        if comp is None:
            if cfg:
                errors.append(f"{section}: component disabled on this host")
            return
        for key, minv in key_min.items():
            if key not in cfg:
                continue
            try:
                val = type(getattr(comp, key))(cfg[key])
                if not val >= minv:
                    raise ValueError(f"must be >= {minv}")
                setattr(comp, key, val)
                updated.append(f"{section}.{key}")
                applied.setdefault(section, {})[key] = val
            except (TypeError, ValueError) as e:
                errors.append(f"{section}.{key}: {e}")

    def apply_config_overrides(self, cfgs: Dict):
        """Apply overrides key-by-key; one invalid value must not block the
        rest. Returns (updated_names, applied_subset, errors)."""
        updated: list = []
        applied: Dict = {}
        errors: list = []
        if not isinstance(cfgs, dict):
            return updated, applied, ["configs must be an object"]
        if "expected_gpu_count" in cfgs:
            comp = self.server.registry.get("accelerator-gpu-counts")
            try:
                n = int(cfgs["expected_gpu_count"])
                if comp is not None:
                    comp.expected_count = n
                    updated.append("expected_gpu_count")
                    applied["expected_gpu_count"] = n
            except (TypeError, ValueError) as e:
                errors.append(f"expected_gpu_count: {e}")
        self._apply_numeric_section(
            "nvlink", "accelerator-gpu-nvlink", cfgs,
            {
                "flap_threshold": 0,
                "crc_delta_degraded": 0,
                "auto_clear_window": 0,   # 0 = sticky until set-healthy
                # any positive window is accepted: a stricter floor here
                # would silently drop previously-persisted overrides at
                # boot replay
                "scan_window": 1,
                "expected_links": 0,      # 0 = derive from topology
            },
            updated, applied, errors,
        )
        nfs_cfg = cfgs.get("nfs_groups")
        if nfs_cfg is not None and not isinstance(nfs_cfg, list):
            errors.append("nfs_groups: must be a list of group objects")
            nfs_cfg = None
        if isinstance(nfs_cfg, list):
            from gpud_tpu_torch.nfs_checker import GroupConfig

            comp = self.server.registry.get("nfs")
            groups = []
            group_errs = []
            for i, g in enumerate(nfs_cfg):
                if not isinstance(g, dict) or not g.get("dir"):
                    group_errs.append(f"nfs_groups[{i}]: dir required")
                    continue
                try:
                    gc = GroupConfig(
                        dir=str(g["dir"]),
                        ttl_seconds=float(g.get("ttl_seconds", 300.0)),
                        expected_members=int(g.get("expected_members", 0)),
                    )
                except (TypeError, ValueError) as e:
                    group_errs.append(f"nfs_groups[{i}]: {e}")
                    continue
                verr = gc.validate()
                if verr:
                    group_errs.append(f"nfs_groups[{i}]: {verr}")
                    continue
                groups.append(gc)
            if group_errs:
                # all-or-nothing: a partially-applied group list would
                # silently stop monitoring the rejected groups
                errors.extend(group_errs)
            elif comp is None:
                # valid push must not vanish silently on a host where the
                # component is disabled — signal the no-op to the CP
                errors.append("nfs_groups: nfs component disabled on this host")
            else:
                comp.group_configs = groups
                updated.append("nfs_groups")
                applied["nfs_groups"] = [
                    {
                        "dir": gc.dir,
                        "ttl_seconds": gc.ttl_seconds,
                        "expected_members": gc.expected_members,
                    }
                    for gc in groups
                ]
        thr_cfg = cfgs.get("error_thresholds")
        if thr_cfg is not None and not isinstance(thr_cfg, dict):
            errors.append("error_thresholds: must be an object of name->threshold")
            thr_cfg = None
        if isinstance(thr_cfg, dict):
            from gpud_tpu_torch.components.gpu import catalog as gpu_catalog

            comp = self.server.registry.get("accelerator-gpu-error-kmsg")
            if comp is None and thr_cfg:
                errors.append(
                    "error_thresholds: error-kmsg component disabled on this host"
                )
            for name, raw_thr in thr_cfg.items() if comp is not None else ():
                if gpu_catalog.lookup(name) is None:
                    errors.append(f"error_thresholds.{name}: unknown error name")
                    continue
                if raw_thr is None:
                    # null removes the override: back to the catalog
                    # default (incl. future catalog changes)
                    comp.reboot_threshold_overrides.pop(name, None)
                    updated.append(f"error_thresholds.{name}")
                    applied.setdefault("error_thresholds", {})[name] = None
                    continue
                try:
                    thr = int(raw_thr)
                    if thr < 0:
                        raise ValueError("must be >= 0")
                except (TypeError, ValueError) as e:
                    errors.append(f"error_thresholds.{name}: {e}")
                    continue
                comp.reboot_threshold_overrides[name] = thr
                updated.append(f"error_thresholds.{name}")
                applied.setdefault("error_thresholds", {})[name] = thr
        self._apply_numeric_section(
            "anomaly", "accelerator-gpu-anomaly", cfgs,
            {
                # zero would silently disable scoring (or flag everything)
                # while reporting 'applied' — require sane floors
                "score_degraded": 0.1,
                "lookback_seconds": 60,
                "min_samples": 2,
            },
            updated, applied, errors,
        )
        self._apply_numeric_section(
            "temperature", "accelerator-gpu-temperature", cfgs,
            {"degraded_c": 1, "unhealthy_c": 1},
            updated, applied, errors,
        )
        return updated, applied, errors

    def _m_updateToken(self, req: Dict) -> Dict:
        token = req.get("token", "")
        if not token:
            return {"error": "token required"}
        # persist the PAIR: the rotation came from the control plane the
        # session is talking to, and must survive a process restart that
        # re-supplies stale boot flags (server.py precedence rule)
        # single read: the FIFO watch thread nulls server.session under its
        # own lock, so a check-then-deref here would race to AttributeError
        session = self.server.session
        if session is not None:
            # atomic pair write — a crash between two separate writes
            # would durably record a mismatched endpoint/token pair
            self.server.persist_credential_pair(session.endpoint, token)
            session.token = token
        else:
            self.server.persist_token(token)
        return {"status": "ok"}

    def _m_getToken(self, req: Dict) -> Dict:
        return {"token": self.server.metadata.get(KEY_TOKEN)}

    def _m_logout(self, req: Dict) -> Dict:
        """Deregister from the control plane: purge credentials
        (reference: logout.go:14-36 purges metadata + stops the daemon)."""
        from gpud_tpu_torch import metadata as md

        for key in (md.KEY_TOKEN, md.KEY_MACHINE_PROOF, md.KEY_MACHINE_ID):
            self.server.metadata.delete(key)
        return {"status": "ok"}

    def _m_delete(self, req: Dict) -> Dict:
        """Machine deletion cleanup: mark every managed package for
        deletion so the package manager's delete loop collects them
        (reference: session_serve.go:188-218 createNeedDeleteFiles —
        'needDelete' there, our contract's 'delete' marker here).

        Deliberately does NOT purge credentials: that is logout's job, and
        the reference control plane sends both methods for a machine
        deletion (delete → package cleanup, logout → creds purge + stop)."""
        import os as _os

        pkgs_dir = self.server.config.packages_dir()
        marked = []
        errors = []
        if _os.path.isdir(pkgs_dir):
            for name in sorted(_os.listdir(pkgs_dir)):
                d = _os.path.join(pkgs_dir, name)
                if not _os.path.isdir(d):
                    continue
                try:
                    with open(_os.path.join(d, "delete"), "w", encoding="utf-8"):
                        pass
                    marked.append(name)
                except OSError as e:
                    # keep going: one unwritable dir must not block the
                    # cleanup of every other package
                    errors.append(f"{name}: {e}")
        audit("session_delete", packages=len(marked), errors=len(errors))
        out: Dict = {"status": "ok", "packages_marked": marked}
        if errors:
            out["errors"] = errors
        return out

    # -- packages / update / plugins --------------------------------------
    def _m_packageStatus(self, req: Dict) -> Dict:
        if self.server.package_manager is None:
            return {"packages": []}
        # probe=False: status.sh probes are subprocesses (30s timeout each)
        # and this runs on the session serve loop — same slow-op rule as
        # gossip/triggerComponent
        return {
            "packages": [
                s.to_dict()
                for s in self.server.package_manager.status(probe=False)
            ]
        }

    def _m_update(self, req: Dict) -> Dict:
        """Write the target-version file; the update watcher acts on it
        (reference: pkg/update/version_file.go:16)."""
        version = req.get("version", "")
        if not version:
            return {"error": "version required"}
        from gpud_tpu_torch.update import write_target_version

        write_target_version(self.server.config.target_version_file(), version)
        return {"status": "ok", "target_version": version}

    # -- kapmtls (reference: kapMTLS{Status,UpdateCredentials,Activate},
    #    session_process_request.go) --------------------------------------
    def _kapmtls(self):
        from gpud_tpu_torch.kapmtls import CertManager

        mgr = getattr(self.server, "kapmtls_manager", None)
        if mgr is None:
            import os as _os

            root = _os.path.join(
                self.server.config.resolved_data_dir(), "kapmtls"
            )
            mgr = CertManager(root=root)
            self.server.kapmtls_manager = mgr
        return mgr

    def _m_kapMTLSStatus(self, req: Dict) -> Dict:
        return {"kapmtls": self._kapmtls().status().to_dict()}

    def _m_kapMTLSUpdateCredentials(self, req: Dict) -> Dict:
        version = req.get("version", "")
        err = self._kapmtls().install(
            version, req.get("cert_pem", ""), req.get("key_pem", "")
        )
        if err:
            return {"error": err}
        if req.get("activate", False):
            err = self._kapmtls().activate(version)
            if err:
                return {"error": f"installed but activation failed: {err}"}
        return {"status": "ok", "version": version}

    def _m_kapMTLSActivate(self, req: Dict) -> Dict:
        err = self._kapmtls().activate(req.get("version", ""))
        return {"error": err} if err else {"status": "ok"}

    def _m_getPluginSpecs(self, req: Dict) -> Dict:
        specs = self.server.plugin_specs or []
        return {"specs": [s.to_dict() for s in specs]}

    def _m_setPluginSpecs(self, req: Dict) -> Dict:
        """Persist new specs; ask the supervisor for a restart so the new
        plugin set takes effect (reference: 137-141 exit-code restart)."""
        from gpud_tpu_torch.plugins.spec import save_specs, specs_from_list

        try:
            specs = specs_from_list(req.get("specs", []))
        except (ValueError, KeyError) as e:
            return {"error": f"invalid specs: {e}"}
        # a spec named like a built-in component would crash-loop the next
        # boot at registration time — reject before persisting
        from gpud_tpu_torch.components.all import all_components

        builtin = {getattr(f, "NAME", "") for f in all_components()}
        clashes = [s.name for s in specs if s.name in builtin]
        if clashes:
            return {"error": f"plugin name(s) clash with built-in components: {clashes}"}
        save_specs(self.server.config.resolved_plugin_specs_file(), specs)
        needs_restart = True
        if needs_restart and self.exit_fn is not None:
            threading.Timer(1.0, lambda: self.exit_fn(RESTART_EXIT_CODE)).start()
        return {"status": "ok", "restarting": needs_restart}
