"""Network utilities (the port of ``gpud_tpu/netutil.py``).

Reference: pkg/netutil — public/private IP discovery, port checks, and
edge-latency measurement (latency/edge/edge.go measures RTT to the global
Tailscale DERP map; here the edge set is configurable TCP targets since a
fleet's relevant edges are the cloud metadata service, DNS, and the
control plane itself; the edges are the reference package's).
"""

from __future__ import annotations

import socket
import time
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

# (name, host, port) — reachable edges whose RTT approximates egress health
DEFAULT_EDGES: List[Tuple[str, str, int]] = [
    ("gcp-metadata", "metadata.google.internal", 80),
    ("google-dns", "8.8.8.8", 53),
    ("cloudflare-dns", "1.1.1.1", 53),
]


def private_ip() -> str:
    """Primary outbound interface's address (no packets are sent: connect
    on a UDP socket only resolves routing)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return ""


def public_ip(timeout: float = 3.0) -> str:
    """Public IP via the GCE metadata service (first choice on GCE VMs),
    empty when unavailable (reference: pkg/netutil public-IP discovery)."""
    try:
        import urllib.request

        req = urllib.request.Request(
            "http://metadata.google.internal/computeMetadata/v1/instance/"
            "network-interfaces/0/access-configs/0/external-ip",
            headers={"Metadata-Flavor": "Google"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode().strip()
    except Exception:  # noqa: BLE001
        return ""


def is_port_open(host: str, port: int, timeout: float = 2.0) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def tcp_rtt_ms(host: str, port: int, timeout: float = 2.0) -> Optional[float]:
    t0 = time.perf_counter()
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return (time.perf_counter() - t0) * 1000.0
    except OSError:
        return None


def measure_edges(
    edges: Optional[List[Tuple[str, str, int]]] = None,
    timeout: float = 2.0,
) -> Dict[str, Optional[float]]:
    """RTT per edge (None = unreachable) — the DERP-map analog
    (reference: pkg/netutil/latency/edge/edge.go:1-9)."""
    out: Dict[str, Optional[float]] = {}
    for name, host, port in edges or DEFAULT_EDGES:
        out[name] = tcp_rtt_ms(host, port, timeout=timeout)
    return out
