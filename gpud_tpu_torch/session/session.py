"""The session's wire frame; the port of ``Frame`` in
``gpud_tpu/session/session.py`` (:108-133), which the outbox's replay
builds. The rest of that module (the ``Session`` transport, its
keep-alive and auth handling) is not ported yet."""

from __future__ import annotations

import json
from typing import Optional


class Frame:
    """One wire frame (reference: session.go Body{ReqID, Data})."""

    def __init__(self, req_id: str = "", data: Optional[dict] = None) -> None:
        self.req_id = req_id
        self.data = data or {}
        self._encoded: Optional[str] = None

    def to_json(self) -> str:
        # cached: the serve loop encodes once to validate serializability;
        # the transport writer reuses that encoding (frames are not
        # mutated after construction)
        if self._encoded is None:
            self._encoded = json.dumps({"req_id": self.req_id, "data": self.data})
        return self._encoded

    @classmethod
    def from_json(cls, line: str) -> Optional["Frame"]:
        try:
            d = json.loads(line)
        except ValueError:
            return None
        if not isinstance(d, dict):
            return None
        return cls(req_id=str(d.get("req_id", "")), data=d.get("data") or {})
