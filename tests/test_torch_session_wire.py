"""Parity of the port's session wire codec (gpud_tpu_torch/session/wire.py)
with gpud_tpu's, on the cases of the reference's tests/test_session_wire.py
and, for the api types the port has, tests/test_wire_roundtrips.py.

Every case runs under both codecs: msgpack framing where msgpack imports,
and the JSON framing each package falls back to without it (``_msgpack``
set to None in both, as on a host without the package). The same records
must give the same encoded arrays, the same batch envelopes and the same
wire bytes, byte for byte; decoding must give back the same objects, and
the same inputs must fail with the same error class. The reference's
cross-revision handshake case (a rev-2 agent against a rev-3 manager,
:222) runs each package's session against its own manager on
127.0.0.1:0."""

import random

import pytest

from gpud_tpu.api.v1 import types as ref_types

from gpud_tpu_torch.api.v1 import types as port_types

from torch_plane_parity import IDS, PKGS, PORT, REF, both

CODECS = ("msgpack", "json")


@pytest.fixture(params=CODECS)
def codec(request, monkeypatch):
    if request.param == "json":
        for P in PKGS:
            monkeypatch.setattr(P.wire, "_msgpack", None)
    elif REF.wire._msgpack is None:
        pytest.skip("msgpack is not installed")
    return request.param


def records_of(P, records, keyframe_interval=64):
    """Encode then decode; both arrays and decoded tuples are returned."""
    enc, dec = P.wire.DeltaEncoder(keyframe_interval=keyframe_interval), P.wire.DeltaDecoder()
    arrays, decoded = [], []
    for seq, ts, kind, key, payload in records:
        arr = enc.encode_record(seq, ts, kind, key, payload)
        arrays.append(arr)
        got = dec.decode_record(arr)
        assert got == (seq, ts, kind, key, payload), f"seq {seq} diverged"
        decoded.append(got)
    return arrays, decoded


def mutations(seed=0xC0FFEE, n=400):
    rng = random.Random(seed)
    components = [f"accelerator-gpu-{i}" for i in range(4)]
    payloads = {c: {"component": c, "state": "healthy", "value": 0.0, "labels": {"pod": "p0"}}
                for c in components}
    records = []
    for seq in range(1, n + 1):
        c = rng.choice(components)
        p = dict(payloads[c])
        mutation = rng.random()
        if mutation < 0.5:
            p["value"] = rng.randrange(1000) / 10.0
        elif mutation < 0.7:
            p["state"] = rng.choice(["healthy", "degraded", "unhealthy"])
        elif mutation < 0.85:
            p[f"extra_{rng.randrange(3)}"] = rng.randrange(10)
        else:
            for k in [k for k in p if k.startswith("extra_")]:
                p.pop(k)
        payloads[c] = p
        records.append((seq, float(seq), "metric", f"k{seq}", p))
    return records


# -- delta codec -------------------------------------------------------------


def random_mutations(P):
    return records_of(P, mutations(), keyframe_interval=16)


def keyframe_cadence(P):
    enc = P.wire.DeltaEncoder(keyframe_interval=4)
    arrays = [enc.encode_record(i + 1, 0.0, "event", f"k{i}", {"component": "a", "i": i})
              for i in range(9)]
    assert [len(a) for a in arrays] == [6, 7, 7, 7, 6, 7, 7, 7, 6]
    other = enc.encode_record(10, 0.0, "event", "kx", {"component": "b"})
    assert len(other) == 6
    return arrays, other


def reset_resyncs(P):
    enc, dec = P.wire.DeltaEncoder(keyframe_interval=64), P.wire.DeltaDecoder()
    dec.decode_record(enc.encode_record(1, 0.0, "event", "k1", {"component": "a", "i": 1}))
    enc.reset()
    arr = enc.encode_record(2, 0.0, "event", "k2", {"component": "a", "i": 2})
    assert len(arr) == 6
    dec.reset()
    return arr, P.wire.DeltaDecoder().decode_record(arr)


def desync_raises(P):
    enc = P.wire.DeltaEncoder()
    enc.encode_record(1, 0.0, "event", "k1", {"component": "a", "i": 0})
    delta = enc.encode_record(2, 0.0, "event", "k2", {"component": "a", "i": 1})
    assert len(delta) == 7
    errors = []
    for bad in (delta, [1, 0.0, "event"], delta + ["junk"], {"not": "an array"}, None,
                ["x", 0.0, "event", "k", "event:", {}]):
        with pytest.raises(P.wire.DeltaDecodeError) as e:
            P.wire.DeltaDecoder().decode_record(bad)
        errors.append(str(e.value))
    return delta, errors


def non_dict_payloads(P):
    return records_of(P, [(1, 0.0, "event", "k1", {"i": 0}), (2, 0.0, "event", "k2", "plain"),
                          (3, 0.0, "event", "k3", {"i": 1}), (4, 0.5, "event", "k4", [1, 2]),
                          (5, 0.5, "event", "k5", {"i": 1, "j": None})])


def decoder_keeps_prior_payloads(P):
    enc, dec = P.wire.DeltaEncoder(), P.wire.DeltaDecoder()
    first = dec.decode_record(enc.encode_record(1, 0.0, "event", "k1", {"component": "a", "i": 0}))
    second = dec.decode_record(enc.encode_record(2, 0.0, "event", "k2", {"component": "a", "i": 1}))
    assert first[4]["i"] == 0 and second[4]["i"] == 1
    return first, second


def stream_keys(P):
    return [P.wire.stream_of(k, p) for k, p in (
        ("event", {"component": "a"}), ("transition", {}), ("ici_link", "x"), ("e", None))]


def batch_envelope(P):
    enc = P.wire.DeltaEncoder()
    recs = [enc.encode_record(i, float(i), "event", f"k{i}", {"i": i}) for i in (3, 4, 5)]
    data = P.wire.build_batch(recs)
    batch = P.wire.parse_batch(data)
    assert (batch["v"], batch["first_seq"], batch["last_seq"], batch["count"]) == (
        P.wire.BATCH_VERSION, 3, 5, 3)
    assert P.wire.parse_batch({"outbox_seq": 1}) is None
    assert P.wire.parse_batch("nope") is None
    assert P.wire.build_batch([])[P.wire.BATCH_KEY]["count"] == 0
    return data, P.wire.build_batch([])


DELTA_CASES = {
    "random_mutations": random_mutations,
    "keyframe_cadence": keyframe_cadence,
    "reset_resyncs": reset_resyncs,
    "desync_raises": desync_raises,
    "non_dict_payloads": non_dict_payloads,
    "decoder_keeps_prior_payloads": decoder_keeps_prior_payloads,
    "stream_keys": stream_keys,
    "batch_envelope": batch_envelope,
}


@pytest.mark.parametrize("case", DELTA_CASES)
def test_the_delta_codec_is_the_reference_s(case):
    ref, port = both(DELTA_CASES[case])
    assert port == ref


def test_the_wire_constants_are_the_reference_s():
    names = ("PREFIX_JSON", "PREFIX_ZLIB", "PREFIX_MSGPACK", "PREFIX_ZLIB_MSGPACK",
             "DEFAULT_KEYFRAME_INTERVAL", "DEFAULT_COMPRESS_MIN_BYTES", "COMPRESS_LEVEL",
             "BATCH_KEY", "BATCH_VERSION")
    ref, port = both(lambda P: [getattr(P.wire, n) for n in names])
    assert port == ref


# -- rev-3 payload framing ---------------------------------------------------


BIG = {"records": [{"component": f"accelerator-gpu-{i % 8}", "state": "healthy",
                    "name": "memory_utilization", "value": i} for i in range(200)]}


def framing(P):
    small = {"method": "outboxAck", "seq": 7}
    buf = P.wire.encode_payload(small)
    assert buf[:1] in (P.wire.PREFIX_JSON, P.wire.PREFIX_MSGPACK)
    assert P.wire.decode_payload(buf) == small
    zbuf = P.wire.encode_payload(BIG, min_bytes=64)
    assert zbuf[:1] in (P.wire.PREFIX_ZLIB, P.wire.PREFIX_ZLIB_MSGPACK)
    assert P.wire.decode_payload(zbuf) == BIG
    floor = P.wire.encode_payload({"a": 1}, min_bytes=10_000)
    assert floor[:1] in (P.wire.PREFIX_JSON, P.wire.PREFIX_MSGPACK)
    tiny_over_floor = P.wire.encode_payload({"a": 1}, min_bytes=0)
    return buf, zbuf, floor, tiny_over_floor, P.wire.encode_payload(BIG)


def noise(P):
    if P.wire._msgpack is None:
        return None
    rng = random.Random(7)
    blob = {"blob": bytes(rng.randrange(256) for _ in range(2048))}
    buf = P.wire.encode_payload(blob, min_bytes=0)
    assert buf[:1] == P.wire.PREFIX_MSGPACK and P.wire.decode_payload(buf) == blob
    return buf


def garbage(P):
    errors = []
    for buf in (b"", b"?whatever", P.wire.PREFIX_ZLIB + b"not-zlib",
                P.wire.PREFIX_JSON + b"{broken", P.wire.PREFIX_MSGPACK + b"\xc1",
                P.wire.PREFIX_ZLIB_MSGPACK + b"\x00"):
        with pytest.raises(P.wire.WireCodecError) as e:
            P.wire.decode_payload(buf)
        errors.append(str(e.value))
    return errors


def configured_floor(P):
    try:
        P.wire.configure(compress_min_bytes=64)
        low = P.wire.encode_payload(BIG)
        P.wire.configure(compress_min_bytes=None)  # unchanged
        still = P.wire.encode_payload(BIG)
        P.wire.configure(compress_min_bytes=-5)
        clamped = P.wire.codec_stats()["compress_min_bytes"]
    finally:
        P.wire.configure(compress_min_bytes=P.wire.DEFAULT_COMPRESS_MIN_BYTES)
    return low, still, clamped


def stats_move(P):
    before = P.wire.codec_stats()
    P.wire.encode_payload({"records": ["x" * 50] * 100}, min_bytes=0)
    after = P.wire.codec_stats()
    assert after["wire_egress_bytes"] > before["wire_egress_bytes"]
    assert after["raw_egress_bytes"] > before["raw_egress_bytes"]
    assert after["compression_ratio"] >= 1.0
    return (after["wire_egress_bytes"] - before["wire_egress_bytes"],
            after["raw_egress_bytes"] - before["raw_egress_bytes"], after["compress_min_bytes"])


def journal_column(P):
    obj = {"component": "gpu0", "value": 1.5, "labels": {"pod": "p"}}
    packed = P.wire.pack_obj(obj)
    assert P.wire.unpack_obj(packed) == obj
    assert P.wire.unpack_obj('{"legacy": true}') == {"legacy": True}
    with pytest.raises(ValueError):
        P.wire.unpack_obj("not json")
    objs = [{"i": i, "component": f"c{i % 3}"} for i in range(50)]
    raws = [P.wire.pack_obj(o) for o in objs]
    assert P.wire.unpack_many(raws) == objs
    mixed = raws[:10] + ['{"legacy": 1}'] + raws[10:]
    assert P.wire.unpack_many(mixed) == objs[:10] + [{"legacy": 1}] + objs[10:]
    assert P.wire.unpack_many([]) == []
    return packed, raws


FRAMING_CASES = {
    "framing": framing,
    "noise": noise,
    "garbage": garbage,
    "configured_floor": configured_floor,
    "stats_move": stats_move,
    "journal_column": journal_column,
}


@pytest.mark.parametrize("case", FRAMING_CASES)
def test_the_framing_is_the_reference_s(case, codec):
    ref, port = both(FRAMING_CASES[case])
    assert port == ref


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_a_msgpack_payload_without_msgpack_fails_loudly(P, monkeypatch):
    if P.wire._msgpack is None:
        pytest.skip("msgpack is not installed")
    buf = P.wire.encode_payload({"a": 1}, min_bytes=10_000)
    assert buf[:1] == P.wire.PREFIX_MSGPACK
    monkeypatch.setattr(P.wire, "_msgpack", None)
    with pytest.raises(P.wire.WireCodecError, match="msgpack is not installed"):
        P.wire.decode_payload(buf)


def test_a_json_journal_reads_under_msgpack(monkeypatch):
    # a journal written on a host without msgpack stays readable on one with it
    rows = {}
    for P in PKGS:
        monkeypatch.setattr(P.wire, "_msgpack", None)
        rows[P.name] = [P.wire.pack_obj({"i": i}) for i in range(5)]
        monkeypatch.undo()
    assert rows["port"] == rows["ref"]
    ref, port = both(lambda P: P.wire.unpack_many(rows[P.name]))
    assert port == ref == [{"i": i} for i in range(5)]


# -- the api types on the wire --------------------------------------------------


def samples(T):
    SA = T.SuggestedActions
    hs = T.HealthState(time=1700000000.25, component="accelerator-gpu-nvlink", health="Unhealthy",
                       reason="link down", error="", suggested_actions=SA(description="reboot", repair_actions=[
                           "REBOOT_SYSTEM", "HARDWARE_INSPECTION"]),
                       extra_info={"links_up": "17", "poll_mode": "fast"})
    ev = T.Event(component="x", time=1700000000.5, name="gpu_fallen_off_bus", type="Fatal",
                 message="GPU 2 lost", extra_info={"gpu": "2"})
    m = T.Metric(unix_seconds=1700000000, name="tpud_gpu_temperature_celsius",
                 labels={"gpu": "3"}, value=61.5)
    ci = T.ComponentInfo(component="cpu", start_time=1.0, end_time=2.0,
                         states=[T.HealthState(time=1.25, component="cpu", health="Healthy",
                                               reason="ok")],
                         events=[T.Event(component="cpu", time=1.5, name="e", message="m")],
                         metrics=[T.Metric(unix_seconds=1, name="n", labels={}, value=0.5)])
    bd = T.BlockDeviceInfo(name="sda", type="disk", size_bytes=1 << 40, model="PD",
                           rotational=False, removable=False,
                           children=[T.BlockDeviceInfo(name="sda1", type="part", mount_point="/",
                                                       fstype="ext4", used_bytes=9)])
    return {"HealthState": hs, "Event": ev, "Metric": m, "SuggestedActions": hs.suggested_actions,
            "ComponentInfo": ci, "BlockDeviceInfo": bd}


@pytest.mark.parametrize("name", ["HealthState", "Event", "Metric", "SuggestedActions",
                                  "ComponentInfo", "BlockDeviceInfo"])
def test_the_api_types_cross_the_wire_as_the_reference_s(name, codec):
    out = {}
    for P, T in ((REF, ref_types), (PORT, port_types)):
        obj = samples(T)[name]
        cls = type(obj)
        d = obj.to_dict()
        buf = P.wire.encode_payload(d, min_bytes=0)
        back = cls.from_dict(P.wire.decode_payload(buf))
        assert back.to_dict() == d
        extra = dict(d, __future_field__={"nested": [1, 2]})
        assert "__future_field__" not in cls.from_dict(extra).to_dict()
        # an empty payload decodes to the defaults; a missing time is "now"
        empty = cls.from_dict({})
        defaults = None if empty is None else {k: v for k, v in empty.to_dict().items()
                                                if k != "time"}
        out[P.name] = (buf, d, defaults)
    assert out["port"] == out["ref"]


def rev2_agent_against_rev3_manager(P, monkeypatch):
    """tests/test_session_wire.py:222: the hello clamps to rev 2 and the
    payloads stay bare JSON."""
    import importlib
    import time

    v2_client = importlib.import_module(P.session.__name__.rsplit(".", 1)[0] + ".v2.client")
    monkeypatch.setattr(v2_client, "MAX_REVISION", 2)
    cp = P.control_plane.ControlPlane()
    cp.start()
    try:
        monkeypatch.setenv("TPUD_SESSION_V2_TARGET", f"127.0.0.1:{cp.grpc_port}")
        s = P.session.Session(endpoint=cp.endpoint, machine_id="old-agent", token="t",
                              machine_proof="p", dispatch_fn=lambda req: {"echo": req.get("method")},
                              protocol="auto")
        s.time_sleep_fn = lambda sec: s._stop.wait(min(sec, 0.02))
        s.start()
        try:
            deadline = time.time() + 15
            while time.time() < deadline and "old-agent" not in cp.agents:
                time.sleep(0.05)
            h = cp.agent("old-agent")
            answer = h.request({"method": "states"}, timeout=10)
            return h.transport, answer
        finally:
            s.stop()
    finally:
        cp.stop()


def test_a_rev2_agent_against_a_rev3_manager_negotiates_down(monkeypatch):
    pytest.importorskip("grpc")
    ref, port = both(rev2_agent_against_rev3_manager, monkeypatch)
    assert port == ref == ("v2-rev2", {"echo": "states"})
