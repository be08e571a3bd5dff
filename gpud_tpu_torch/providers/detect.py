"""Cloud provider detection.

Reference: pkg/providers — per-cloud IMDS fetchers (aws/azure/gcp/nebius/
nscale/oci subdirs) behind a generic ``Detector``/``RegionDetector``
(detect.go:13-51), with an ASN fallback (pkg/asn) when no IMDS answers.
GCP is first and richest, as in the reference package (on a TPU VM it
also yields the accelerator-type metadata).
"""

from __future__ import annotations

import concurrent.futures
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

IMDS_TIMEOUT = 1.5


@dataclass
class DetectResult:
    provider: str = ""
    region: str = ""
    zone: str = ""
    instance_type: str = ""
    accelerator_type: str = ""   # GCP TPU VMs only
    raw: Dict[str, str] = field(default_factory=dict)


def _http_get(url: str, headers: Dict[str, str], timeout: float = IMDS_TIMEOUT) -> str:
    import urllib.request

    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace").strip()


def detect_gcp(get_fn: Callable = _http_get) -> Optional[DetectResult]:
    base = "http://metadata.google.internal/computeMetadata/v1"
    h = {"Metadata-Flavor": "Google"}
    try:
        zone_path = get_fn(f"{base}/instance/zone", h)
    except Exception:  # noqa: BLE001
        return None
    zone = zone_path.rsplit("/", 1)[-1]
    region = zone.rsplit("-", 1)[0] if "-" in zone else zone
    res = DetectResult(provider="gcp", region=region, zone=zone)
    try:
        res.instance_type = get_fn(
            f"{base}/instance/machine-type", h
        ).rsplit("/", 1)[-1]
    except Exception:  # noqa: BLE001
        pass
    for attr in ("accelerator-type", "tpu-env"):
        try:
            v = get_fn(f"{base}/instance/attributes/{attr}", h)
            res.raw[attr] = v
            if attr == "accelerator-type":
                res.accelerator_type = v
        except Exception:  # noqa: BLE001
            pass
    return res


def detect_aws(get_fn: Callable = _http_get) -> Optional[DetectResult]:
    base = "http://169.254.169.254/latest"
    try:
        token = _imds_v2_token()
        h = {"X-aws-ec2-metadata-token": token} if token else {}
        doc = get_fn(f"{base}/dynamic/instance-identity/document", h)
        d = json.loads(doc)
        return DetectResult(
            provider="aws",
            region=d.get("region", ""),
            zone=d.get("availabilityZone", ""),
            instance_type=d.get("instanceType", ""),
        )
    except Exception:  # noqa: BLE001
        return None


def _imds_v2_token() -> str:
    import urllib.request

    try:
        req = urllib.request.Request(
            "http://169.254.169.254/latest/api/token",
            method="PUT",
            headers={"X-aws-ec2-metadata-token-ttl-seconds": "60"},
        )
        with urllib.request.urlopen(req, timeout=IMDS_TIMEOUT) as resp:
            return resp.read().decode()
    except Exception:  # noqa: BLE001
        return ""


def detect_azure(get_fn: Callable = _http_get) -> Optional[DetectResult]:
    try:
        doc = get_fn(
            "http://169.254.169.254/metadata/instance/compute?api-version=2021-02-01",
            {"Metadata": "true"},
        )
        d = json.loads(doc)
        return DetectResult(
            provider="azure",
            region=d.get("location", ""),
            zone=d.get("zone", ""),
            instance_type=d.get("vmSize", ""),
        )
    except Exception:  # noqa: BLE001
        return None


def detect_oci(get_fn: Callable = _http_get) -> Optional[DetectResult]:
    """OCI IMDS v2 (reference: pkg/providers/oci/imds/imds.go:14 —
    opc/v2 with the Bearer Oracle header)."""
    base = "http://169.254.169.254/opc/v2"
    h = {"Authorization": "Bearer Oracle"}
    try:
        region = get_fn(f"{base}/instance/canonicalRegionName", h)
    except Exception:  # noqa: BLE001
        return None
    res = DetectResult(provider="oci", region=region)
    try:
        res.instance_type = get_fn(f"{base}/instance/shape", h)
    except Exception:  # noqa: BLE001
        pass
    try:
        res.zone = get_fn(f"{base}/instance/availabilityDomain", h)
    except Exception:  # noqa: BLE001
        pass
    return res


# nebius/nscale mount instance identity as files, not an IMDS endpoint
# (reference: pkg/providers/nebius/nebius.go:10, nscale.go — both read
# /mnt/cloud-metadata)
CLOUD_METADATA_PATH = "/mnt/cloud-metadata"


def detect_metadata_mount(root: str = "") -> Optional[DetectResult]:
    import os

    base = root or CLOUD_METADATA_PATH
    if not os.path.isdir(base):
        return None

    def read(name: str) -> str:
        try:
            with open(os.path.join(base, name), "r", encoding="utf-8") as f:
                return f.read().strip()
        except OSError:
            return ""

    parent = read("parent-id")
    instance = read("instance-id")
    if not parent or not instance:
        return None
    cluster = read("gpu-cluster-id")
    parts = [parent] + ([cluster] if cluster else []) + [instance]
    # both nebius and nscale use this mount; distinguish on best-effort
    # markers, defaulting to nebius (reference keeps them as two detectors
    # over the same path)
    provider = "nscale" if read("org-id") else "nebius"
    return DetectResult(
        provider=provider,
        raw={"instance_id": "/".join(parts)},
    )


DETECTORS: List[Callable[[], Optional[DetectResult]]] = [
    detect_gcp,
    detect_aws,
    detect_azure,
    detect_oci,
    detect_metadata_mount,
]


def detect(timeout: float = 5.0) -> DetectResult:
    """Try all detectors concurrently; first hit wins, GCP preferred
    (reference: detect.go runs per-cloud fetchers and falls back to ASN).

    ``timeout`` is a real wall-clock bound: straggler detectors (e.g.
    blackholed IMDS on firewalled hosts) are abandoned, not joined — their
    threads die with their own HTTP timeouts."""
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=len(DETECTORS))
    results: Dict[str, DetectResult] = {}
    try:
        futures = {ex.submit(d): d.__name__ for d in DETECTORS}
        try:
            for fut in concurrent.futures.as_completed(futures, timeout=timeout):
                r = fut.result()
                if r is not None:
                    results[r.provider] = r
        except concurrent.futures.TimeoutError:
            pass
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
    for preferred in ("gcp", "aws", "azure", "oci", "nebius", "nscale"):
        if preferred in results:
            return results[preferred]
    # no IMDS answered: fall back to the ASN lookup. public_ip() only knows
    # GCE metadata, which just failed — so ask ip.guide about our own
    # address (self-lookup), which works from any egress-capable host
    # (reference: detect.go falls back to pkg/asn)
    try:
        from gpud_tpu_torch import asn as asnmod

        info = asnmod.lookup("")
        if info is not None and info.provider:
            return DetectResult(
                provider=info.provider, raw={"asn": str(info.asn), "org": info.org}
            )
    except Exception:  # noqa: BLE001 — fallback must never fail detection
        pass
    return DetectResult(provider="unknown")
