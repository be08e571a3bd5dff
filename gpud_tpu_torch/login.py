"""Control-plane registration.

Reference: pkg/login/login.go:157 ``Login`` — builds a LoginRequest with
machine info + provider + location (pkg/machine-info/login_request.go:17-158),
POSTs it to the control plane, persists machineID/token/machineProof to the
metadata table. Machine-id overwrite semantics (login.go:28-71): a
control-plane-assigned machine id replaces the local one so re-imaged
nodes keep their fleet identity. Node labels get the
``user.node.tpud.dev/`` prefix normalization (reference: node_labels.go,
``user.node.lepton.ai/``).

The port of ``gpud_tpu/login.py``: the POST goes through the standard
library's ``http.client`` (``gpud_tpu_torch/http_client.py``) where the
reference package uses ``requests``, with the same URL, JSON body,
timeout and error contract; the machine info carries ``gpu_info``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from gpud_tpu_torch import http_client
from gpud_tpu_torch import machine_info as machineinfo
from gpud_tpu_torch.api.v1.types import LoginRequest, LoginResponse
from gpud_tpu_torch.log import audit, get_logger
from gpud_tpu_torch.metadata import (
    KEY_ENDPOINT,
    KEY_LOGIN_SUCCESS_TS,
    KEY_MACHINE_ID,
    KEY_MACHINE_PROOF,
    KEY_NODE_LABELS,
    KEY_PRIVATE_IP,
    KEY_PUBLIC_IP,
    KEY_TOKEN,
    normalize_endpoint,
    Metadata,
)

logger = get_logger(__name__)

NODE_LABEL_PREFIX = "user.node.tpud.dev/"
LOGIN_TIMEOUT = 30.0


def normalize_node_labels(labels: Dict[str, str]) -> Dict[str, str]:
    """Reference: pkg/login/node_labels.go — user labels are namespaced."""
    out = {}
    for k, v in labels.items():
        if not k.startswith(NODE_LABEL_PREFIX):
            k = NODE_LABEL_PREFIX + k
        out[k] = v
    return out


def login(
    endpoint: str,
    token: str,
    metadata: Metadata,
    gpu_instance=None,
    node_labels: Optional[Dict[str, str]] = None,
    provider: str = "",
    region: str = "",
    public_ip: str = "",
    private_ip: str = "",
    post_fn=None,
) -> LoginResponse:
    """POST /api/v1/login; persist identity on success. ``post_fn`` is
    injectable for tests (reference pattern: session.go:262-296)."""
    machine_id = metadata.machine_id() or ""
    req = LoginRequest(
        token=token,
        machine_id=machine_id,
        network={"public_ip": public_ip, "private_ip": private_ip},
        machine_info=machineinfo.get_machine_info(
            gpu=gpu_instance,
            machine_id=machine_id,
            provider=provider,
            region=region,
            public_ip=public_ip,
            private_ip=private_ip,
        ),
        node_labels=normalize_node_labels(node_labels or {}),
        provider=provider,
        region=region,
    )

    if post_fn is None:
        def post_fn(url, body):  # noqa: ANN001
            return http_client.post_json(url, body, timeout=LOGIN_TIMEOUT)

    endpoint = normalize_endpoint(endpoint)
    url = endpoint + "/api/v1/login"
    body = post_fn(url, req.to_dict())
    resp = LoginResponse.from_dict(body)
    if resp.error:
        raise RuntimeError(f"login rejected: {resp.error}")

    # persist identity (reference: login.go:28-71 overwrite semantics) in
    # ONE transaction — a crash mid-login must not leave a token paired
    # with a stale endpoint
    identity = {KEY_TOKEN: resp.token or token, KEY_ENDPOINT: endpoint}
    if resp.machine_id:
        identity[KEY_MACHINE_ID] = resp.machine_id
    if resp.machine_proof:
        identity[KEY_MACHINE_PROOF] = resp.machine_proof
    if node_labels:
        identity[KEY_NODE_LABELS] = json.dumps(normalize_node_labels(node_labels))
    if public_ip:
        identity[KEY_PUBLIC_IP] = public_ip
    if private_ip:
        identity[KEY_PRIVATE_IP] = private_ip
    identity[KEY_LOGIN_SUCCESS_TS] = str(time.time())
    metadata.set_many(identity)
    audit("login", endpoint=endpoint, machine_id=resp.machine_id or machine_id)
    logger.info("logged in to %s as %s", endpoint, resp.machine_id or machine_id)
    return resp
