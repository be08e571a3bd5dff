"""A recorded stream of a fleet's outbox deliveries, made from a numpy seed,
for the manager parity tests (tests/test_torch_manager_parity.py). It
imports neither package: the caller hands it a wire codec module, so a
fresh interpreter can load it beside one package only."""

import numpy as np

SEED = 1107
AGENTS = [f"agent-{i}" for i in range(6)] + ["peer:m-b"]  # a peer-named id is an agent here
COMPONENTS = ("accelerator-gpu-error-kmsg", "accelerator-gpu-nvlink", "accelerator-gpu-memory",
              "cpu")
CID = "cid-parity-0"
NOW = 5000.0
T0 = 1000.0
TABLE = "tpud_fleet_journal_v0_1"


def link_body(rng, state, ts, nvlink):
    if nvlink:  # one NVLink port of a GPU (gpud_tpu_torch/fabric/mesh.py)
        gpu, port = int(rng.integers(0, 2)), int(rng.integers(0, 18))
        head = {"link": f"gpu{gpu}/nvlink{port}", "src_chip": gpu, "dst_chip": -1,
                "axis": "nvlink"}
    else:  # a torus link of the reference's fabric
        a = int(rng.integers(0, 3))
        head = {"link": f"c{a}-c{a + 1}/x", "src_chip": a, "dst_chip": a + 1, "axis": "x"}
    return {**head, "state": state, "latency_seconds": float(rng.uniform(1e-4, 5e-3)),
            "deviation": float(rng.uniform(0, 9)), "ts": ts}


def record_stream(rng, agent_index):
    """One agent's records: (kind, dedupe key, payload) with rising ts."""
    out, ts, state = [], T0 + agent_index, {}
    for n in range(48):
        ts += float(rng.uniform(0.5, 30.0))
        kind = str(rng.choice(["transition", "transition", "remediation_audit", "ici_link",
                               "predict_score", "event"]))
        comp = str(rng.choice(COMPONENTS))
        if kind == "transition":
            frm = state.get(comp, "Healthy")
            to = str(rng.choice([s for s in ("Healthy", "Unhealthy", "Degraded") if s != frm]))
            state[comp] = to
            body = {"component": comp, "from": frm, "to": to, "ts": ts, "reason": "parity"}
            if agent_index == 0 and n == 1:
                body["correlation_id"] = CID
            key = f"transition:{comp}:{ts}:{to}"
        elif kind == "remediation_audit":
            body = {"component": comp, "action": "reboot_system",
                    "outcome": str(rng.choice(["dry_run", "executed", "refused", ""])), "ts": ts}
            key = f"audit:{comp}:{ts}"
        elif kind == "ici_link":
            body = link_body(rng, str(rng.choice(["up", "degraded", "down"])), ts,
                             nvlink=agent_index % 2 == 0)
            key = f"ici_link:{body['link']}:{ts}"
        elif kind == "predict_score":
            event = str(rng.choice(["warn", "clear", "lead", "snapshot"]))
            body = {"schema": 2 if rng.uniform() < 0.1 else 1, "component": comp,
                    "component_class": "gpu", "event": event,
                    "score": float(rng.uniform(-0.1, 1.1)), "armed": bool(rng.uniform() < 0.5),
                    "threshold": 0.6, "ts": ts,
                    "warned_at": ts - 5.0 if event == "warn" else None,
                    "features": {"latency": float(rng.uniform()), "flap": float(rng.uniform())}}
            if event == "lead":
                body["lead_seconds"] = float(rng.uniform(-5, 600))
            key = f"predict:{comp}:{ts}:{event}"
        else:
            body = {"component": comp, "name": f"e{n}", "ts": ts,
                    "correlation_id": CID if rng.uniform() < 0.1 else ""}
            key = f"event:{comp}:{ts}:e{n}"
        out.append((kind, key, body))
    return out


def delivery_frames(wire):
    """Per agent, the frames of its deliveries, in order: ``(connection,
    req_id, frame)``. A connection number starts a fresh handle (a
    reconnect: a fresh delta decoder on the manager, a reset encoder on
    the agent). Either package's wire codec gives the same bytes
    (tests/test_torch_session_wire.py)."""
    rng = np.random.default_rng(SEED)
    frames = {}
    for ai, agent in enumerate(AGENTS):
        recs = [(seq, ts_of(b), kind, key, b)
                for seq, (kind, key, b) in enumerate(record_stream(rng, ai), start=1)]
        enc, conn, out, i = wire.DeltaEncoder(keyframe_interval=16), 0, [], 0
        while i < len(recs):
            size = int(rng.integers(1, 12))
            chunk = recs[i:i + size]
            roll = rng.uniform()
            if roll < 0.1 and i > 0:
                # a legacy agent's single-record frame
                seq, ts, kind, key, body = chunk[0]
                out.append((conn, f"outbox-{seq}", {"outbox_seq": seq, "ts": ts, "kind": kind,
                                                    "dedupe_key": key, "payload": body}))
                i += 1
                continue
            encoded = [enc.encode_record(*r) for r in chunk]
            if roll < 0.2 and len(chunk) > 2:
                # a delta desync: the frame's second record is lost on the
                # way, so its tail decodes against no base; the agent
                # reconnects and redelivers from the first record keyframe-
                # anchored
                out.append((conn, f"outbox-batch-{chunk[0][0]}",
                            wire.build_batch([encoded[0]] + encoded[2:])))
                conn += 1
                enc.reset()
                encoded = [enc.encode_record(*r) for r in chunk]
            out.append((conn, f"outbox-batch-{chunk[0][0]}-{chunk[-1][0]}",
                        wire.build_batch(encoded)))
            if roll > 0.9:
                # redelivery across a reconnect: the same records again
                conn += 1
                enc.reset()
                out.append((conn, f"outbox-batch-{chunk[0][0]}-{chunk[-1][0]}",
                            wire.build_batch([enc.encode_record(*r) for r in chunk])))
            i += size
        frames[agent] = out
    return frames


def ts_of(body):
    return body["ts"]


def interleaved(frames):
    """Every agent's frames, agents taking turns (a fleet, not a queue)."""
    queues = {a: list(f) for a, f in frames.items()}
    while any(queues.values()):
        for agent in AGENTS:
            if queues[agent]:
                yield agent, queues[agent].pop(0)
