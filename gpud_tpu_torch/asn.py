"""Public-IP → ASN/provider lookup.

Reference: pkg/asn/asn.go:18-24 — queries ip.guide for the ASN owning the
node's public IP, used as the provider-detection fallback when no cloud
IMDS answers (pkg/providers/detect.go). The lookup function is injectable
and failures degrade to "unknown" — zero-egress environments simply skip.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Optional

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

LOOKUP_URL = "https://ip.guide/{ip}"
# ip.guide with no path resolves the caller's own IP — usable even when
# the node can't discover its public IP via any cloud metadata service
LOOKUP_URL_SELF = "https://ip.guide/"
TIMEOUT = 5.0

# ASN org substrings → canonical provider names
_ORG_PROVIDERS = {
    "google": "gcp",
    "amazon": "aws",
    "aws": "aws",
    "microsoft": "azure",
    "oracle": "oci",
    "nebius": "nebius",
}


@dataclass
class ASNInfo:
    asn: int = 0
    org: str = ""
    provider: str = ""


def _default_fetch(url: str) -> Optional[dict]:
    import urllib.request

    with urllib.request.urlopen(url, timeout=TIMEOUT) as resp:
        return json.loads(resp.read().decode())


def lookup(ip: str = "", fetch_fn: Callable[[str], Optional[dict]] = _default_fetch) -> Optional[ASNInfo]:
    """Returns None when the lookup fails (offline, bad IP). Empty ``ip``
    asks ip.guide about the caller's own address."""
    try:
        d = fetch_fn(LOOKUP_URL.format(ip=ip) if ip else LOOKUP_URL_SELF)
    except Exception as e:  # noqa: BLE001
        logger.debug("asn lookup failed: %s", e)
        return None
    if not d:
        return None
    # "network": null appears for unrouted/bogon IPs — `or {}` both layers
    asn_obj = (d.get("network") or {}).get("autonomous_system") or d.get(
        "autonomous_system"
    ) or {}
    org = str(asn_obj.get("organization", "") or asn_obj.get("name", ""))
    info = ASNInfo(asn=int(asn_obj.get("asn", 0) or 0), org=org)
    lower = org.lower()
    for needle, provider in _ORG_PROVIDERS.items():
        if needle in lower:
            info.provider = provider
            break
    return info
