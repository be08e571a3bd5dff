"""Host-wide all-links sweep with per-link EWMA latency baselines; the port
of ``gpud_tpu/fabric/plane.py``.

The plane runs one scheduler job (``fabric-sweep``) that, each tick:

1. resolves the fabric (``fabric/mesh.py``: the NVML or mock NVLink port
   inventory, or a degraded mesh with no links);
2. folds the port states into per-link up/down (a link is one GPU's
   NVLink port);
3. probes each link's latency — on hardware the operator can point
   ``telemetry_fn`` at a per-axis collective timing; off-hardware a
   deterministic synthetic probe keeps the EWMA machinery exercised
   (the chaos/bench planes override ``telemetry_fn`` to inject ramps);
4. updates each link's EWMA baseline and flags Degraded on deviation
   (z past ``latency_threshold_z``), not just down — the "quiet
   degradation" failure mode "When GPUs Fail Quietly" documents for
   NVLink;
5. records the matrix row set into ``FabricMatrixStore`` and publishes
   ``ici_link`` outbox records (the reference's kind, which the manager
   reads) for every not-up link and every state change (including
   recovery).

Per-link gauges are cardinality-bounded: at most ``metric_links_max``
links are exported (sorted by name for stable series), the rest are
counted in ``tpud_fabric_metric_links_truncated``. The default cap (64)
is below an 8-GPU host's 144 links, as the reference's cap is below a
large slice's link count.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from gpud_tpu_torch.fabric import mesh as meshmod
from gpud_tpu_torch.fabric.mesh import MeshLink, MeshSpec, link_port_state, mesh_links
from gpud_tpu_torch.fabric.store import FabricMatrixStore
from gpud_tpu_torch.gpu.instance import LinkState
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge, histogram
from gpud_tpu_torch.predict.features import Ewma, clamp01, neighbor_cooccurrence

logger = get_logger(__name__)

JOB_NAME = "fabric-sweep"

STATE_UP = "up"
STATE_DEGRADED = "degraded"
STATE_DOWN = "down"

_STATE_RANK = {STATE_UP: 0, STATE_DEGRADED: 1, STATE_DOWN: 2}

# deterministic off-hardware probe baseline (seconds) — constant, so an
# un-faulted link's EWMA variance collapses and any injected ramp is an
# unambiguous deviation (predict/features.Ewma.z has a relative floor)
SYNTHETIC_LATENCY_SECONDS = 1e-4

DEFAULT_METRIC_LINKS_MAX = 64

_g_link_health = gauge(
    "tpud_ici_link_health",
    "per logical fabric link: 2=up, 1=degraded (EWMA latency deviation), "
    "0=down (cardinality bounded; see tpud_fabric_metric_links_truncated)",
)
_g_link_deviation = gauge(
    "tpud_ici_link_deviation",
    "per logical fabric link: latency deviation from the link's EWMA "
    "baseline, in z-score units (cardinality bounded)",
)
_h_link_latency = histogram(
    "tpud_ici_link_latency_seconds",
    "per-axis sweep probe latency across all links of that axis",
    buckets=(1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5),
)
_c_sweeps = counter(
    "tpud_fabric_sweeps_total",
    "completed all-links fabric sweeps",
)
_h_sweep = histogram(
    "tpud_fabric_sweep_duration_seconds",
    "wall time of one all-links fabric sweep",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5),
)
_g_links = gauge(
    "tpud_fabric_links",
    "logical fabric links the sweep observes (0 on a degraded mesh)",
)
_g_links_degraded = gauge(
    "tpud_fabric_links_degraded",
    "links currently flagged degraded by EWMA latency deviation",
)
_g_links_down = gauge(
    "tpud_fabric_links_down",
    "links currently hard-down (the link's port down)",
)
_g_truncated = gauge(
    "tpud_fabric_metric_links_truncated",
    "links beyond the per-link gauge cardinality cap this sweep "
    "(still swept, stored, and shipped — only the gauges are capped)",
)


class _LinkTrack:
    """Per-link sweep state: EWMA baseline + last published verdict."""

    __slots__ = ("ewma", "state", "deviation", "latency", "last_ts",
                 "last_degraded_ts", "samples")

    def __init__(self, alpha: float) -> None:
        self.ewma = Ewma(alpha)
        self.state = ""
        self.deviation = 0.0
        self.latency = 0.0
        self.last_ts = 0.0
        self.last_degraded_ts = 0.0
        self.samples = 0


class FabricPlane:
    """Owns the mesh, the baselines, the matrix, and the sweep job.

    Thread-safe: the sweep runs on a scheduler worker while reads come
    from the HTTP executor, the session serve loop, and the predict
    scan. All mutable sweep state lives under ``_mu``; probing and
    storage run outside it.
    """

    GUARDED_BY = {
        "_mesh": "_mu",
        "_links": "_mu",
        "_tracks": "_mu",
        "_adjacency": "_mu",
        "_sweeps": "_mu",
        "_last_sweep_ts": "_mu",
        "_last_duration": "_mu",
        "_published": "_mu",
    }

    # the NVLink component whose predict feature set we feed (neighbor
    # co-occurrence signal; components/gpu/nvlink.py)
    component_name = "accelerator-gpu-nvlink"

    def __init__(
        self,
        db,
        gpu=None,
        writer=None,
        interval_seconds: float = 60.0,
        latency_threshold_z: float = 4.0,
        ewma_alpha: float = 0.3,
        warmup_sweeps: int = 3,
        retention_seconds: float = 7 * 86400.0,
        metric_links_max: int = DEFAULT_METRIC_LINKS_MAX,
        time_now_fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.store = FabricMatrixStore(db, writer=writer)
        self.gpu = gpu
        self.interval_seconds = float(interval_seconds)
        self.latency_threshold_z = float(latency_threshold_z)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup_sweeps = int(warmup_sweeps)
        self.retention_seconds = float(retention_seconds)
        self.metric_links_max = int(metric_links_max)
        self.time_now_fn = time_now_fn or time.time
        self.store.time_now_fn = self.time_now_fn
        # injectables (chaos/bench/hardware override; None = defaults)
        self.telemetry_fn: Optional[Callable[[MeshLink], float]] = None
        self.links_fn: Optional[Callable[[], list]] = None
        self.on_publish: Optional[Callable[[dict], None]] = None
        self._mu = threading.Lock()
        self._mesh: Optional[MeshSpec] = None
        self._links: List[MeshLink] = []
        self._tracks: Dict[str, _LinkTrack] = {}
        self._adjacency: Dict[str, List[str]] = {}
        self._sweeps = 0
        self._last_sweep_ts = 0.0
        self._last_duration = 0.0
        self._published = 0
        self._job = None

    # -- defaults ----------------------------------------------------------
    def synthetic_latency(self, link: MeshLink) -> float:  # noqa: ARG002
        """Deterministic off-hardware probe (module docstring)."""
        return SYNTHETIC_LATENCY_SECONDS

    def default_links(self) -> list:
        """NVLink port snapshots from the GPU adapter (NVML or mock)."""
        if self.gpu is None:
            return []
        try:
            return self.gpu.nvlink_links()
        except Exception as exc:  # noqa: BLE001 — backend probe failed
            logger.debug("fabric port walk failed: %s", exc)
            return []

    # -- mesh --------------------------------------------------------------
    def _discover_locked(self) -> None:
        mesh = meshmod.discover_mesh(self.gpu)
        links = mesh_links(mesh)
        self._mesh = mesh
        self._links = links
        self._adjacency = _build_adjacency(links)
        stale = set(self._tracks) - {ln.name for ln in links}
        for name in stale:
            del self._tracks[name]
        logger.info(
            "fabric mesh discovered: shape=%s source=%s links=%d",
            "x".join(str(d) for d in mesh.shape), mesh.source, len(links),
        )

    def rediscover(self) -> None:
        """Force re-discovery on the next sweep (topology change)."""
        with self._mu:
            self._mesh = None

    # -- sweep -------------------------------------------------------------
    def sweep_once(self) -> Dict:
        """One all-links sweep; returns the recorded matrix row list."""
        t0 = time.monotonic()
        now = self.time_now_fn()
        with self._mu:
            if self._mesh is None:
                self._discover_locked()
            mesh = self._mesh
            links = list(self._links)
        # probe outside the lock: port walk + latency hook may block
        snaps = (self.links_fn or self.default_links)()
        port_up = {
            (s.gpu_id, s.link_id): s.state == LinkState.UP for s in snaps
        }
        probe = self.telemetry_fn or self.synthetic_latency
        probed: List[tuple] = []
        for link in links:
            up = link_port_state(link, port_up)
            try:
                latency = float(probe(link))
            except Exception as exc:  # noqa: BLE001 — operator hook failed
                logger.debug("fabric probe failed for %s: %s", link.name, exc)
                latency = 0.0
            probed.append((link, up, latency))
        with self._mu:
            rows, publishes = self._apply_sweep_locked(probed, now)
            self._sweeps += 1
            self._last_sweep_ts = now
            self._last_duration = time.monotonic() - t0
            duration = self._last_duration
            self._published += len(publishes)
        self.store.insert_sweep(rows, ts=now)
        sink = self.on_publish
        if sink is not None:
            for body in publishes:
                try:
                    sink(body)
                except Exception:  # noqa: BLE001 — outbox must not kill sweep
                    logger.exception("fabric publish hook failed")
        self._export_metrics(mesh, rows, duration)
        return {"ts": now, "links": len(rows), "published": len(publishes)}

    def _apply_sweep_locked(
        self, probed: List[tuple], now: float
    ) -> tuple:
        rows: List[Dict] = []
        publishes: List[Dict] = []
        threshold = self.latency_threshold_z
        for link, up, latency in probed:
            tr = self._tracks.get(link.name)
            if tr is None:
                tr = self._tracks[link.name] = _LinkTrack(self.ewma_alpha)
            prev_state = tr.state
            deviation = 0.0
            if up is False:
                state = STATE_DOWN
            else:
                if tr.samples >= self.warmup_sweeps:
                    deviation = tr.ewma.z(latency)
                if deviation >= threshold:
                    # deviating sample: flag, and keep it OUT of the
                    # baseline so a persistent latency shift stays
                    # flagged instead of being absorbed
                    state = STATE_DEGRADED
                else:
                    state = STATE_UP
                    tr.ewma.update(latency)
                    tr.samples += 1
            tr.state = state
            tr.deviation = deviation
            tr.latency = latency
            tr.last_ts = now
            if state == STATE_DEGRADED:
                tr.last_degraded_ts = now
            row = dict(link.to_dict())
            row.update({
                "ts": now,
                "state": state,
                "latency_seconds": latency,
                "deviation": deviation,
            })
            rows.append(row)
            if state != STATE_UP or (prev_state and prev_state != state):
                publishes.append(dict(row))
        return rows, publishes

    def _export_metrics(self, mesh, rows: List[Dict], duration: float) -> None:
        _c_sweeps.inc()
        _h_sweep.observe(duration)
        _g_links.set(len(rows))
        degraded = sum(1 for r in rows if r["state"] == STATE_DEGRADED)
        down = sum(1 for r in rows if r["state"] == STATE_DOWN)
        _g_links_degraded.set(degraded)
        _g_links_down.set(down)
        exported = sorted(rows, key=lambda r: r["link"])[: self.metric_links_max]
        _g_truncated.set(max(0, len(rows) - len(exported)))
        for r in exported:
            labels = {"link": r["link"]}
            _g_link_health.set(
                float(2 - _STATE_RANK[r["state"]]), labels=labels
            )
            _g_link_deviation.set(float(r["deviation"]), labels=labels)
        for r in rows:
            _h_link_latency.observe(
                r["latency_seconds"], labels={"axis": r["axis"]}
            )

    # -- reads -------------------------------------------------------------
    def status(self) -> Dict:
        """Sweep/mesh summary (``GET /v1/fabric``, ``fabricStatus``)."""
        with self._mu:
            mesh = self._mesh
            degraded = sorted(
                name for name, tr in self._tracks.items()
                if tr.state == STATE_DEGRADED
            )
            down = sorted(
                name for name, tr in self._tracks.items()
                if tr.state == STATE_DOWN
            )
            return {
                "mesh": mesh.to_dict() if mesh else None,
                "links": len(self._links),
                "sweeps": self._sweeps,
                "last_sweep_ts": self._last_sweep_ts,
                "last_sweep_seconds": self._last_duration,
                "interval_seconds": self.interval_seconds,
                "latency_threshold_z": self.latency_threshold_z,
                "warmup_sweeps": self.warmup_sweeps,
                "degraded": degraded[:32],
                "down": down[:32],
                "published": self._published,
            }

    def matrix(self) -> List[Dict]:
        """Current per-link matrix, one row per logical link, sorted."""
        with self._mu:
            links = list(self._links)
            out = []
            for link in sorted(links, key=lambda ln: ln.name):
                tr = self._tracks.get(link.name)
                row = link.to_dict()
                row.update({
                    "state": tr.state if tr and tr.state else "",
                    "latency_seconds": tr.latency if tr else 0.0,
                    "deviation": tr.deviation if tr else 0.0,
                    "ts": tr.last_ts if tr else 0.0,
                    "last_degraded_ts": tr.last_degraded_ts if tr else 0.0,
                })
                out.append(row)
            return out

    def history(
        self, link: str = "", since: float = 0.0, limit: int = 256
    ) -> List[Dict]:
        return self.store.history(link=link, since=since, limit=limit)

    def deviation_scores(self) -> Dict[str, float]:
        """Per-link deviation normalized to [0,1] for the predict plane:
        0.5 at the degrade threshold, 1.0 at twice it or hard-down."""
        scale = 2.0 * max(1e-9, self.latency_threshold_z)
        with self._mu:
            out: Dict[str, float] = {}
            for name, tr in self._tracks.items():
                if tr.state == STATE_DOWN:
                    out[name] = 1.0
                else:
                    out[name] = clamp01(tr.deviation / scale)
            return out

    def cooccurrence_score(self) -> float:
        """Neighbor co-occurrence over the link adjacency — correlated
        deviations on ports of one GPU score together."""
        with self._mu:
            adjacency = self._adjacency
        return neighbor_cooccurrence(self.deviation_scores(), adjacency)

    # -- lifecycle ---------------------------------------------------------
    def start(self, scheduler) -> None:
        self._job = scheduler.add_job(
            JOB_NAME,
            self.sweep_once,
            interval=self.interval_seconds,
            initial_delay=self.interval_seconds,
        )

    def poke(self) -> None:
        """Run a sweep now (chaos expectations, trigger paths)."""
        job = self._job
        if job is not None and hasattr(job, "poke"):
            job.poke()
        else:
            self.sweep_once()

    def purge_once(self) -> int:
        """Retention hook: drop matrix rows past the window."""
        return self.store.purge(
            before=self.time_now_fn() - self.retention_seconds
        )

    def close(self) -> None:
        job, self._job = self._job, None
        if job is not None and hasattr(job, "cancel"):
            job.cancel()


def _build_adjacency(links: List[MeshLink]) -> Dict[str, List[str]]:
    """link name -> names of the links of the same GPU. The switch side is
    never an endpoint: every link ends there, so counting it would make
    every link adjacent to every other."""
    by_chip: Dict[int, List[str]] = {}
    for ln in links:
        by_chip.setdefault(ln.src_chip, []).append(ln.name)
    adj: Dict[str, set] = {ln.name: set() for ln in links}
    for names in by_chip.values():
        for name in names:
            adj[name].update(n for n in names if n != name)
    return {name: sorted(peers) for name, peers in adj.items()}
