"""Manager peer set: rendezvous routing + per-peer health state; the port
of ``gpud_tpu/manager/peers.py``.

The HA manager tier (docs/fleet.md "Federation & failover") runs N
manager processes as a peer set. Two questions every peer must answer
identically, with no coordination:

- **Which peer owns agent X?** Highest-random-weight (rendezvous)
  hashing over the agent's stable crc32 slot (manager/shard.py) crossed
  with each peer id: every peer computes the same owner from nothing but
  the shared peer list, and removing one peer only remaps that peer's
  cohort (the property plain modulo hashing lacks).
- **Which peer replicates my journal?** The ring successor by sorted
  peer id — each manager ships its rollup-journal appends to exactly one
  other peer (federation.py), so any single death leaves a complete
  replicated prefix on one survivor.

``PeerSet`` also carries the mutable per-peer health state the probe
loop and scatter-gather fan-out update; everything mutable is guarded by
one lock (GUARDED_BY, tools/guard_lint.py).

The routing is the reference's bit for bit (the port's ``slot_of`` equals
the reference's), so a peer set may mix managers of both packages and
every one of them computes the same owner for every agent.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional

from gpud_tpu_torch.manager.shard import slot_of

__all__ = [
    "PeerDescriptor",
    "PeerSet",
    "PeerSpecError",
    "owner_of",
    "parse_peer_spec",
    "rendezvous_rank",
    "rendezvous_score",
]


class PeerSpecError(ValueError):
    """A malformed ``peer_id=endpoint[|grpc_target]`` spec string."""


class PeerDescriptor:
    """One manager in the peer set (immutable identity + addresses)."""

    __slots__ = ("peer_id", "endpoint", "grpc_target")

    def __init__(
        self, peer_id: str, endpoint: str, grpc_target: str = ""
    ) -> None:
        self.peer_id = peer_id
        self.endpoint = endpoint.rstrip("/")
        self.grpc_target = grpc_target

    def to_dict(self) -> dict:
        return {
            "peer_id": self.peer_id,
            "endpoint": self.endpoint,
            "grpc_target": self.grpc_target,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PeerDescriptor({self.peer_id!r}, {self.endpoint!r})"


def parse_peer_spec(spec: str) -> PeerDescriptor:
    """Parse ``peer_id=http://host:port[|grpc_host:grpc_port]``.

    The gRPC target is optional: federation replication falls back to
    the v1 HTTP session streams when the peer doesn't advertise one.
    """
    spec = (spec or "").strip()
    if "=" not in spec:
        raise PeerSpecError(
            f"peer spec {spec!r} must be peer_id=endpoint[|grpc_target]"
        )
    peer_id, _, addr = spec.partition("=")
    peer_id = peer_id.strip()
    addr, _, grpc_target = addr.partition("|")
    addr = addr.strip()
    if not peer_id or not addr:
        raise PeerSpecError(f"peer spec {spec!r} has an empty id or endpoint")
    if not addr.startswith(("http://", "https://")):
        raise PeerSpecError(
            f"peer spec {spec!r}: endpoint must be an http(s) URL"
        )
    return PeerDescriptor(peer_id, addr, grpc_target.strip())


def rendezvous_score(agent_id: str, peer_id: str) -> int:
    """HRW weight of ``peer_id`` for ``agent_id``.

    Hashes the agent's stable slot (not the raw id) crossed with the
    peer id, reusing the crc32 slot discipline from manager/shard.py:
    the slot column already journaled with every record is the same
    value routing decisions are made from, so a rebuilt store and the
    rendezvous map can never disagree about cohort membership.
    """
    slot = slot_of(agent_id)
    return zlib.crc32(f"{slot}:{peer_id}".encode("utf-8", "replace"))


def rendezvous_rank(agent_id: str, peer_ids: List[str]) -> List[str]:
    """Peer ids ranked best-first for ``agent_id`` (deterministic:
    score desc, then peer id as the tiebreak)."""
    return sorted(
        peer_ids, key=lambda p: (-rendezvous_score(agent_id, p), p)
    )


def owner_of(agent_id: str, peer_ids: List[str]) -> Optional[str]:
    """The owning peer for ``agent_id`` (None for an empty set)."""
    ranked = rendezvous_rank(agent_id, list(peer_ids))
    return ranked[0] if ranked else None


class PeerSet:
    """The full peer map from one manager's point of view.

    Identity (the descriptor list, which peer is *self*) is frozen at
    construction; per-peer health is the mutable part, updated by the
    federation probe loop and read by every scatter-gather envelope.
    """

    # all mutable per-peer health state shares one lock; the descriptor
    # map and ring order are construction-frozen and read lock-free
    GUARDED_BY = {
        "_failures": "_mu",
        "_reachable": "_mu",
        "_last_seen": "_mu",
        "_last_error": "_mu",
        "_rtt_ms": "_mu",
        "_adopted": "_mu",
    }

    def __init__(
        self,
        self_id: str,
        peers: List[PeerDescriptor],
        dead_after_probes: int = 3,
    ) -> None:
        by_id: Dict[str, PeerDescriptor] = {}
        for p in peers:
            if p.peer_id in by_id:
                raise PeerSpecError(f"duplicate peer id {p.peer_id!r}")
            by_id[p.peer_id] = p
        if self_id not in by_id:
            raise PeerSpecError(
                f"self peer id {self_id!r} missing from the peer list"
            )
        self.self_id = self_id
        self.peers = by_id
        self.ring = sorted(by_id)  # successor order: sorted peer ids
        self.dead_after_probes = max(1, int(dead_after_probes))
        self._mu = threading.Lock()
        self._failures: Dict[str, int] = {p: 0 for p in by_id}
        self._reachable: Dict[str, bool] = {p: True for p in by_id}
        self._last_seen: Dict[str, float] = {p: 0.0 for p in by_id}
        self._last_error: Dict[str, str] = {p: "" for p in by_id}
        self._rtt_ms: Dict[str, float] = {p: 0.0 for p in by_id}
        self._adopted: Dict[str, bool] = {p: False for p in by_id}

    # -- routing (construction-frozen, lock-free) --------------------------
    def owner_of(self, agent_id: str) -> PeerDescriptor:
        return self.peers[owner_of(agent_id, self.ring)]

    def owns(self, agent_id: str) -> bool:
        return owner_of(agent_id, self.ring) == self.self_id

    def successor_of(self, peer_id: str) -> Optional[PeerDescriptor]:
        """Ring successor (sorted-id order); None for a 1-peer set."""
        if len(self.ring) < 2 or peer_id not in self.peers:
            return None
        i = self.ring.index(peer_id)
        return self.peers[self.ring[(i + 1) % len(self.ring)]]

    def successor(self) -> Optional[PeerDescriptor]:
        """This manager's replication target."""
        return self.successor_of(self.self_id)

    def predecessor(self) -> Optional[PeerDescriptor]:
        """The peer whose journal this manager holds the replica of."""
        if len(self.ring) < 2:
            return None
        i = self.ring.index(self.self_id)
        return self.peers[self.ring[(i - 1) % len(self.ring)]]

    def others(self) -> List[PeerDescriptor]:
        return [self.peers[p] for p in self.ring if p != self.self_id]

    def cohort_counts(self, agent_ids: List[str]) -> Dict[str, int]:
        """How many of ``agent_ids`` each peer owns (the rendezvous map
        surfaced by ``GET /v1/fleet/peers``)."""
        counts = {p: 0 for p in self.ring}
        for aid in agent_ids:
            counts[owner_of(aid, self.ring)] += 1
        return counts

    # -- health ------------------------------------------------------------
    def mark_probe(
        self,
        peer_id: str,
        ok: bool,
        now: float,
        rtt_ms: float = 0.0,
        error: str = "",
    ) -> bool:
        """Record one probe outcome; returns True when this probe flips
        the peer to unreachable (the adopt trigger edge)."""
        with self._mu:
            if peer_id not in self._failures:
                return False
            was = self._reachable[peer_id]
            if ok:
                self._failures[peer_id] = 0
                self._reachable[peer_id] = True
                self._last_seen[peer_id] = now
                self._last_error[peer_id] = ""
                self._rtt_ms[peer_id] = rtt_ms
                if not was:
                    self._adopted[peer_id] = False  # peer came back
                return False
            self._failures[peer_id] += 1
            self._last_error[peer_id] = error
            if self._failures[peer_id] >= self.dead_after_probes:
                self._reachable[peer_id] = False
                return was  # edge only on the reachable→dead flip
            return False

    def mark_adopted(self, peer_id: str) -> None:
        with self._mu:
            if peer_id in self._adopted:
                self._adopted[peer_id] = True

    def is_adopted(self, peer_id: str) -> bool:
        with self._mu:
            return self._adopted.get(peer_id, False)

    def is_reachable(self, peer_id: str) -> bool:
        with self._mu:
            return self._reachable.get(peer_id, False)

    def live_others(self) -> List[PeerDescriptor]:
        """Remote peers currently believed reachable (fan-out targets)."""
        with self._mu:
            return [
                self.peers[p]
                for p in self.ring
                if p != self.self_id and self._reachable[p]
            ]

    def health_block(self, now: float) -> List[dict]:
        """The ``peers`` envelope block: one row per peer, self first."""
        rows = []
        with self._mu:
            for pid in sorted(
                self.ring, key=lambda p: (p != self.self_id, p)
            ):
                d = self.peers[pid].to_dict()
                d["self"] = pid == self.self_id
                d["reachable"] = (
                    True if pid == self.self_id else self._reachable[pid]
                )
                d["consecutive_failures"] = self._failures[pid]
                d["last_seen"] = self._last_seen[pid]
                d["age_seconds"] = (
                    round(now - self._last_seen[pid], 3)
                    if self._last_seen[pid] > 0
                    else None
                )
                d["last_error"] = self._last_error[pid]
                d["rtt_ms"] = round(self._rtt_ms[pid], 3)
                d["adopted"] = self._adopted[pid]
                rows.append(d)
        return rows
