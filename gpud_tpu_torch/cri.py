"""Minimal CRI (Container Runtime Interface) gRPC client.

Reference: components/containerd/cri.go — the reference lists pods and
containers over the containerd CRI socket using k8s.io/cri-api. Vendoring
the full CRI proto tree is ~10k lines for the three RPCs we need, so this
module carries a small protobuf wire-format codec and hand-written message
shapes for exactly:

- ``runtime.v1.RuntimeService/Version``
- ``runtime.v1.RuntimeService/ListContainers``
- ``runtime.v1.RuntimeService/ListPodSandbox``

(with a ``runtime.v1alpha2`` fallback for older containerd). gRPC framing
comes from grpcio with identity serializers; only the protobuf payloads
are hand-coded. Field numbers follow k8s.io/cri-api/pkg/apis/runtime/v1.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

DEFAULT_SOCKET = "/run/containerd/containerd.sock"
DEFAULT_TIMEOUT = 5.0

CONTAINER_STATES = {
    0: "created",
    1: "running",
    2: "exited",
    3: "unknown",
}
SANDBOX_STATES = {0: "ready", 1: "notready"}


# ---------------------------------------------------------------------------
# protobuf wire-format codec (encode used for requests and test fixtures,
# decode for responses)
# ---------------------------------------------------------------------------

def encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_field_varint(field: int, v: int) -> bytes:
    return encode_varint(field << 3 | 0) + encode_varint(v)


def encode_field_bytes(field: int, data: bytes) -> bytes:
    return encode_varint(field << 3 | 2) + encode_varint(len(data)) + data


def encode_field_str(field: int, s: str) -> bytes:
    return encode_field_bytes(field, s.encode("utf-8"))


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def parse_message(data: bytes) -> Dict[int, List]:
    """Parse one protobuf message into {field_number: [raw values]} —
    ints for varint/fixed fields, bytes for length-delimited ones."""
    fields: Dict[int, List] = {}
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            v, i = _read_varint(data, i)
        elif wire == 1:  # 64-bit
            if i + 8 > len(data):
                raise ValueError("truncated fixed64")
            v = struct.unpack_from("<q", data, i)[0]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            if i + ln > len(data):
                raise ValueError("truncated bytes field")
            v = data[i : i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            if i + 4 > len(data):
                raise ValueError("truncated fixed32")
            v = struct.unpack_from("<i", data, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def _first_str(fields: Dict[int, List], n: int) -> str:
    v = fields.get(n, [b""])[0]
    return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)


def _first_int(fields: Dict[int, List], n: int) -> int:
    v = fields.get(n, [0])[0]
    return v if isinstance(v, int) else 0


def _parse_map_entry(data: bytes) -> Tuple[str, str]:
    f = parse_message(data)
    return _first_str(f, 1), _first_str(f, 2)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class CRIClient:
    """Talks CRI over a unix socket. All methods raise ``CRIError`` on
    transport/decode failure so callers can classify 'socket present but
    runtime unresponsive'."""

    def __init__(
        self,
        socket_path: str = DEFAULT_SOCKET,
        timeout: float = DEFAULT_TIMEOUT,
        target: str = "",
    ) -> None:
        # `target` overrides the unix socket (tests use localhost tcp)
        self.target = target or f"unix://{socket_path}"
        self.timeout = timeout
        self._channel = None
        self._api_version = "v1"

    def _chan(self):
        if self._channel is None:
            import grpc

            self._channel = grpc.insecure_channel(self.target)
        return self._channel

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    def _call(self, method: str, request: bytes) -> bytes:
        import grpc

        full = f"/runtime.{self._api_version}.RuntimeService/{method}"
        fn = self._chan().unary_unary(
            full,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        try:
            return fn(request, timeout=self.timeout)
        except grpc.RpcError as e:
            # older containerd serves only v1alpha2 — same wire shapes
            if (
                self._api_version == "v1"
                and e.code() == grpc.StatusCode.UNIMPLEMENTED
            ):
                self._api_version = "v1alpha2"
                return self._call(method, request)
            if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                # neither API served: CRI plugin disabled, not a failure
                raise CRIUnservedError(f"{method}: CRI not served") from e
            raise CRIError(f"{method}: {e.code().name}: {e.details()}") from e

    def snapshot(self) -> Dict:
        """Version + container/sandbox listing in one call set; raises
        CRIUnservedError when the runtime deliberately doesn't serve CRI,
        CRIError/RpcError on real failures."""
        return {
            "version": self.version(),
            "containers": self.list_containers(),
            "sandboxes": self.list_pod_sandboxes(),
        }

    # -- RPCs -------------------------------------------------------------
    def version(self) -> Dict[str, str]:
        raw = self._call("Version", encode_field_str(1, "v1"))
        f = parse_message(raw)
        return {
            "version": _first_str(f, 1),
            "runtime_name": _first_str(f, 2),
            "runtime_version": _first_str(f, 3),
            "runtime_api_version": _first_str(f, 4),
        }

    def list_containers(self) -> List[Dict]:
        raw = self._call("ListContainers", b"")
        out = []
        for c in parse_message(raw).get(1, []):
            f = parse_message(c)
            meta = parse_message(f.get(3, [b""])[0])
            labels = dict(
                _parse_map_entry(e) for e in f.get(8, [])
            )
            out.append(
                {
                    "id": _first_str(f, 1),
                    "pod_sandbox_id": _first_str(f, 2),
                    "name": _first_str(meta, 1),
                    "image": _first_str(parse_message(f.get(4, [b""])[0]), 1),
                    "state": CONTAINER_STATES.get(_first_int(f, 6), "unknown"),
                    "created_at": _first_int(f, 7),
                    "labels": labels,
                }
            )
        return out

    def list_pod_sandboxes(self) -> List[Dict]:
        raw = self._call("ListPodSandbox", b"")
        out = []
        for p in parse_message(raw).get(1, []):
            f = parse_message(p)
            meta = parse_message(f.get(2, [b""])[0])
            out.append(
                {
                    "id": _first_str(f, 1),
                    "name": _first_str(meta, 1),
                    "namespace": _first_str(meta, 3),
                    "state": SANDBOX_STATES.get(_first_int(f, 3), "unknown"),
                    "created_at": _first_int(f, 4),
                }
            )
        return out


class CRIError(Exception):
    pass


class CRIUnservedError(CRIError):
    """The runtime answered, but with UNIMPLEMENTED on every CRI API —
    the CRI plugin is disabled (e.g. containerd as Docker's backend), which
    is a configuration, not a health failure."""


def grpc_available() -> bool:
    """grpcio is an optional extra; callers must not read its absence as a
    runtime failure."""
    try:
        import grpc  # noqa: F401

        return True
    except ImportError:
        return False


def probe(socket_path: str = DEFAULT_SOCKET, timeout: float = DEFAULT_TIMEOUT,
          target: str = "") -> Optional[Dict]:
    """One-shot snapshot; ``{"unserved": True}`` when CRI is deliberately
    not served, None on transport failure."""
    client = CRIClient(socket_path, timeout, target=target)
    try:
        return client.snapshot()
    except CRIUnservedError:
        return {"unserved": True}
    except Exception as e:  # noqa: BLE001 — callers treat None as unresponsive
        logger.debug("CRI probe failed: %s", e)
        return None
    finally:
        client.close()
