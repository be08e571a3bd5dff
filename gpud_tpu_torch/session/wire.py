"""Session wire codec: batched outbox frames, delta encoding, compression;
the port of ``gpud_tpu/session/wire.py``.

Without this module every record would cross the session as its own
JSON frame with its own ack round-trip, and the wire, not storage, would
bound delivery. Three layers close the gap, each independently
degradable:

- **Batch frames**: ``SessionOutbox.replay_once`` packs up to
  ``replay_batch`` records into one ``{"outbox_batch": {...}}`` frame;
  the manager ingests the batch and answers a single cumulative
  ``outboxAck`` watermark (the ``MAX(acked_seq, ?)`` SQL watermark
  absorbs it for free), collapsing N ack round-trips into 1.
- **Delta encoding** (:class:`DeltaEncoder` / :class:`DeltaDecoder`):
  most health transitions and metric gauges differ from the previous
  record of the same (kind, component) stream in 2–3 fields, so records
  carry a top-level dict diff against the stream's previous payload,
  with a full keyframe every ``keyframe_interval`` records and whenever
  the encoder resets (reconnect, send failure). The decoder applies
  diffs exactly; a delta arriving without its keyframe base raises
  :class:`DeltaDecodeError` so the manager acks only the decoded prefix
  and the agent redelivers keyframe-anchored.
- **Optional compression + binary framing** on the v2 tunnel at
  negotiated revision >= 3: every ``Frame.data`` /
  ``Result.payload_json`` byte string carries a 1-byte codec prefix
  (``j`` = raw JSON, ``z`` = zlib JSON, ``m`` = msgpack, ``M`` = zlib
  msgpack); payloads under ``compress_min_bytes`` — or that zlib fails
  to shrink — ship uncompressed. msgpack is used when importable (it
  serializes several times faster than ``json`` and ~25% smaller) and
  degrades to JSON framing when absent — both peers run this module, so
  a decoder always understands every prefix its build can emit. Rev-2
  peers negotiate down and see plain JSON bytes, so cross-revision
  fleets interoperate (docs/session.md).

Byte accounting rides ``tpud_session_wire_bytes_total{direction,codec}``
and the ``tpud_session_wire_compression_ratio`` gauge (raw JSON bytes
over on-wire bytes, cumulative since process start).
"""

from __future__ import annotations

import json
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.metrics.registry import counter, gauge

try:  # the container bakes msgpack in; degrade to JSON framing without it
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - exercised only on slim installs
    _msgpack = None

# rev-3 wire framing: 1-byte codec prefix on every payload byte string
PREFIX_JSON = b"j"
PREFIX_ZLIB = b"z"
PREFIX_MSGPACK = b"m"
PREFIX_ZLIB_MSGPACK = b"M"

DEFAULT_KEYFRAME_INTERVAL = 64    # full payload every K records per stream
DEFAULT_COMPRESS_MIN_BYTES = 512  # don't zlib tiny payloads (header > win)
COMPRESS_LEVEL = 1                # throughput-biased: the wire bench gates
                                  # frames/sec as well as bytes/frame, and
                                  # level 1 already captures most of the
                                  # repetition win on delta-encoded batches

BATCH_KEY = "outbox_batch"
BATCH_VERSION = 1

_c_wire_bytes = counter(
    "tpud_session_wire_bytes_total",
    "session payload bytes crossing the wire codec, by direction "
    "(egress/ingress) and codec (json/zlib/msgpack)",
)
_g_wire_ratio = gauge(
    "tpud_session_wire_compression_ratio",
    "cumulative raw-JSON bytes over on-wire bytes for egress payloads "
    "(1.0 = no win; higher is better)",
)

_stats_mu = threading.Lock()
_raw_egress_bytes = 0
_wire_egress_bytes = 0

# process-wide knobs, set once from config at server startup
# (configure()); module defaults serve tests and standalone tools
_compress_min_bytes = DEFAULT_COMPRESS_MIN_BYTES


def configure(compress_min_bytes: Optional[int] = None) -> None:
    """Apply config knobs (server startup; see config.py
    ``session_wire_compress_min_bytes``)."""
    global _compress_min_bytes
    if compress_min_bytes is not None:
        _compress_min_bytes = max(0, int(compress_min_bytes))


def _record_egress(raw_len: int, wire_len: int, codec: str) -> None:
    global _raw_egress_bytes, _wire_egress_bytes
    _c_wire_bytes.inc(wire_len, {"direction": "egress", "codec": codec})
    with _stats_mu:
        _raw_egress_bytes += raw_len
        _wire_egress_bytes += wire_len
        if _wire_egress_bytes:
            _g_wire_ratio.set(_raw_egress_bytes / _wire_egress_bytes)


def codec_stats() -> Dict:
    """Cumulative egress byte accounting (outboxStatus / bench)."""
    with _stats_mu:
        raw, wire = _raw_egress_bytes, _wire_egress_bytes
    return {
        "raw_egress_bytes": raw,
        "wire_egress_bytes": wire,
        "compression_ratio": round(raw / wire, 3) if wire else 1.0,
        "compress_min_bytes": _compress_min_bytes,
    }


class WireCodecError(ValueError):
    """Undecodable wire payload (unknown prefix, corrupt zlib body)."""


class DeltaDecodeError(ValueError):
    """A delta record arrived without its keyframe base — the decoder
    lost sync (new connection, dropped keyframe). The ingester acks only
    the decoded prefix; the agent's stall fallback redelivers the rest
    keyframe-anchored (outbox.reset_delivery / redeliver_after)."""


# -- rev-3 payload framing ---------------------------------------------------

def pack_obj(obj) -> bytes:
    """Object → compact serialized bytes, NO codec prefix: msgpack when
    available, else compact JSON. For single-process storage (the outbox
    journal column) where :func:`unpack_obj` is the only reader — wire
    traffic uses the prefix-framed :func:`encode_payload` instead."""
    if _msgpack is not None:
        return _msgpack.packb(obj, use_bin_type=True, default=str)
    return json.dumps(obj, separators=(",", ":"), default=str).encode("utf-8")


def unpack_obj(raw):
    """Inverse of :func:`pack_obj`; also reads legacy JSON text rows (a
    journal written before the msgpack column encoding, or by a build
    without msgpack). Raises ValueError on garbage."""
    if isinstance(raw, bytes):
        if _msgpack is not None:
            try:
                return _msgpack.unpackb(raw, raw=False, strict_map_key=False)
            except Exception:  # noqa: BLE001 - fall through to JSON sniff
                pass
        return json.loads(raw)
    return json.loads(raw)


def unpack_many(raws: List) -> List:
    """Bulk :func:`unpack_obj` — the replay hot path reads thousands of
    journal rows per batch, and a streaming Unpacker decodes them in one
    C-level pass instead of one Python call per row. Falls back to
    row-by-row decoding when any row isn't clean msgpack (legacy JSON
    text, or a JSON-bytes row from a build without msgpack — those yield
    a different object count, which the length check catches because a
    journaled payload is always a dict, never a 1-byte document)."""
    if _msgpack is not None and raws:
        try:
            unp = _msgpack.Unpacker(raw=False, strict_map_key=False)
            unp.feed(b"".join(raws))  # TypeError on str rows -> fallback
            objs = list(unp)
            if len(objs) == len(raws):
                return objs
        except Exception:  # noqa: BLE001 - any decode trouble -> fallback
            pass
    return [unpack_obj(r) for r in raws]


def encode_payload(obj, min_bytes: Optional[int] = None) -> bytes:
    """Object → prefix-framed wire bytes (rev >= 3 only — rev-2 peers
    expect bare JSON). msgpack body when available, JSON otherwise; zlib
    applies above ``min_bytes`` and only when it actually shrinks the
    payload."""
    if _msgpack is not None:
        raw = _msgpack.packb(obj, use_bin_type=True, default=str)
        plain, packed = PREFIX_MSGPACK, PREFIX_ZLIB_MSGPACK
        codec = "msgpack"
    else:
        raw = json.dumps(obj, separators=(",", ":"), default=str).encode("utf-8")
        plain, packed = PREFIX_JSON, PREFIX_ZLIB
        codec = "json"
    floor = _compress_min_bytes if min_bytes is None else min_bytes
    if len(raw) >= floor:
        z = zlib.compress(raw, COMPRESS_LEVEL)
        if len(z) + 1 < len(raw):
            out = packed + z
            _record_egress(len(raw), len(out), "zlib")
            return out
    out = plain + raw
    _record_egress(len(raw), len(out), codec)
    return out


def decode_payload(buf: bytes):
    """Prefix-framed wire bytes → object (inverse of encode_payload)."""
    if not buf:
        raise WireCodecError("empty wire payload")
    prefix, body = buf[:1], buf[1:]
    if prefix in (PREFIX_ZLIB, PREFIX_ZLIB_MSGPACK):
        try:
            raw = zlib.decompress(body)
        except zlib.error as e:
            raise WireCodecError(f"corrupt zlib payload: {e}") from e
        _c_wire_bytes.inc(len(buf), {"direction": "ingress", "codec": "zlib"})
        packed = prefix == PREFIX_ZLIB_MSGPACK
    elif prefix in (PREFIX_JSON, PREFIX_MSGPACK):
        raw = body
        packed = prefix == PREFIX_MSGPACK
        _c_wire_bytes.inc(
            len(buf),
            {"direction": "ingress",
             "codec": "msgpack" if packed else "json"},
        )
    else:
        raise WireCodecError(f"unknown wire codec prefix {prefix!r}")
    if packed:
        if _msgpack is None:
            raise WireCodecError(
                "msgpack-framed payload but msgpack is not installed"
            )
        try:
            return _msgpack.unpackb(raw, raw=False, strict_map_key=False)
        except Exception as e:  # noqa: BLE001 - msgpack raises many types
            raise WireCodecError(f"corrupt msgpack payload: {e}") from e
    try:
        return json.loads(raw)
    except ValueError as e:
        raise WireCodecError(f"wire payload is not JSON: {e}") from e


# -- delta codec -------------------------------------------------------------

# sentinel for "key absent": unequal (by identity) to every JSON value,
# including None, at C comparison speed
_MISSING = object()


def stream_of(kind: str, payload) -> str:
    """Delta stream key: records delta against the previous payload of
    the same (kind, component) — the repetitive axis of the telemetry."""
    component = ""
    if isinstance(payload, dict):
        component = str(payload.get("component", ""))
    return f"{kind}:{component}"


class DeltaEncoder:
    """Stateful per-stream delta encoder (agent side; NOT thread-safe —
    the outbox serializes access under its own lock).

    ``encode_record`` emits a positional array — field names would be
    re-packed and re-parsed for every record on the hot drain path:

    - keyframe: ``[seq, ts, kind, key, stream, payload]`` (length 6)
    - delta: ``[seq, ts, kind, key, stream, set, del]`` (length 7),
      a top-level dict diff against the stream's previous payload where
      changed/added keys are replaced wholesale (nested values are not
      recursed), ``set`` is the changed-key map (or None) and ``del``
      the removed-key list (or None)

    ``reset()`` forgets all stream state so the next record per stream
    is a keyframe — called on reconnect and on transport send failure,
    because the peer's decoder state is unknown from that point on.

    The encoder keeps a REFERENCE to each payload as the stream's diff
    base (no defensive copy — this sits on the hot replay path, bench.py
    --wire): callers must not mutate a payload after handing it in.
    ``SessionOutbox.replay_once`` satisfies this by construction — every
    row is freshly deserialized from the journal.
    """

    def __init__(self, keyframe_interval: int = DEFAULT_KEYFRAME_INTERVAL) -> None:
        self.keyframe_interval = max(1, int(keyframe_interval))
        # stream → (previous payload, records since last keyframe)
        self._streams: Dict[str, Tuple[Dict, int]] = {}

    def reset(self) -> None:
        self._streams.clear()

    def encode_record(
        self, seq: int, ts: float, kind: str, dedupe_key: str, payload
    ) -> List:
        if not isinstance(payload, dict):
            # non-dict payloads never delta; drop any stale stream base
            stream = f"{kind}:"
            self._streams.pop(stream, None)
            return [seq, ts, kind, dedupe_key, stream, payload]
        stream = f"{kind}:{payload.get('component', '')}"
        prev = self._streams.get(stream)
        if prev is None or prev[1] + 1 >= self.keyframe_interval:
            self._streams[stream] = (payload, 0)
            return [seq, ts, kind, dedupe_key, stream, payload]
        base, since = prev
        get = base.get
        changed = {
            k: v for k, v in payload.items() if get(k, _MISSING) != v
        }
        removed = None
        # keys-view equality is one C-level set compare; the per-key scan
        # only runs when the key sets actually diverged
        if base.keys() != payload.keys():
            rm = [k for k in base if k not in payload]
            if rm:
                removed = rm
        self._streams[stream] = (payload, since + 1)
        return [seq, ts, kind, dedupe_key, stream, changed or None, removed]


class DeltaDecoder:
    """Exact inverse of :class:`DeltaEncoder` (manager side, one per
    connection — a fresh connection starts with keyframes because the
    agent resets its encoder on reconnect).

    Like the encoder, decoded payloads are kept by REFERENCE as diff
    bases: callers must treat the returned payload as read-only."""

    def __init__(self) -> None:
        self._streams: Dict[str, Dict] = {}

    def reset(self) -> None:
        self._streams.clear()

    def decode_record(self, rec) -> Tuple[int, float, str, str, object]:
        """Record array → ``(seq, ts, kind, dedupe_key, payload)``.

        Raises :class:`DeltaDecodeError` on a malformed record or a
        delta without a base. Only ``seq`` is coerced (the ack watermark
        does arithmetic on it); the other fields ride through as the
        peer sent them — both ends run this module, so the types are
        right by construction, and a hot drain decodes hundreds of
        thousands of records.
        """
        try:
            n = len(rec)
            seq = rec[0]
            if type(seq) is not int:
                seq = int(seq)
            ts, kind, key, stream = rec[1], rec[2], rec[3], rec[4]
        except (KeyError, IndexError, TypeError, ValueError) as e:
            raise DeltaDecodeError(f"malformed wire record: {e}") from e
        if n == 6:  # keyframe
            payload = rec[5]
            if isinstance(payload, dict):
                self._streams[stream] = payload
            else:
                self._streams.pop(stream, None)
            return seq, ts, kind, key, payload
        if n != 7:
            raise DeltaDecodeError(
                f"wire record of length {n} (seq {seq})"
            )
        base = self._streams.get(stream)
        if base is None:
            raise DeltaDecodeError(
                f"delta for stream {stream!r} without a keyframe base "
                f"(seq {seq})"
            )
        payload = dict(base)
        s = rec[5]
        if s:
            payload.update(s)
        dels = rec[6]
        if dels:
            for k in dels:
                payload.pop(k, None)
        self._streams[stream] = payload
        return seq, ts, kind, key, payload


# -- batch frames ------------------------------------------------------------

def build_batch(records: List[List]) -> Dict:
    """Encoded records → the ``Frame.data`` dict of one delivery batch."""
    return {
        BATCH_KEY: {
            "v": BATCH_VERSION,
            "first_seq": records[0][0] if records else 0,
            "last_seq": records[-1][0] if records else 0,
            "count": len(records),
            "records": records,
        }
    }


def parse_batch(data) -> Optional[Dict]:
    """Frame data → the batch dict, or None when it isn't a batch frame
    (legacy per-record payloads, operator responses)."""
    if isinstance(data, dict):
        batch = data.get(BATCH_KEY)
        if isinstance(batch, dict):
            return batch
    return None
