"""Metadata key-value table.

Reference: pkg/metadata/metadata.go:33-53 — persists machine_id, token,
machine_proof, endpoint, public/private IP, node labels, login timestamp in
the state DB so the daemon can resume its control-plane identity across
restarts and reboots.
"""

from __future__ import annotations

from typing import Dict, Optional

from gpud_tpu_torch.sqlite import DB

TABLE = "tpud_metadata_v0_1"

# canonical keys (reference: pkg/metadata/metadata.go:33-53)
KEY_MACHINE_ID = "machine_id"
KEY_TOKEN = "token"
KEY_MACHINE_PROOF = "machine_proof"
KEY_ENDPOINT = "endpoint"
KEY_PUBLIC_IP = "public_ip"
KEY_PRIVATE_IP = "private_ip"
KEY_NODE_LABELS = "node_labels"
KEY_LOGIN_SUCCESS_TS = "login_success_ts"
KEY_EXPECTED_GPU_COUNT = "expected_gpu_count"
KEY_ACCELERATOR_TYPE = "accelerator_type"
KEY_CONFIG_OVERRIDES = "config_overrides"
# persisted auth-failure record (reference: session auth-failure
# persistence, session_v2.go:359): "<unix_ts>|<reason>"
KEY_LAST_AUTH_FAILURE = "last_auth_failure"
# NVLink expected-link baseline: most links ever observed on this host, so a
# link that vanished across a daemon restart still alarms
KEY_NVLINK_MAX_LINKS_SEEN = "nvlink_max_links_seen"


def normalize_endpoint(value) -> str:
    """Canonical control-plane endpoint form (no trailing slash).

    Applied at every WRITE site (login, FIFO rotation, updateToken) so
    readers can compare persisted values without re-normalizing."""
    return (value or "").rstrip("/")


class Metadata:
    def __init__(self, db: DB) -> None:
        self.db = db
        db.execute(
            f"CREATE TABLE IF NOT EXISTS {TABLE} (key TEXT PRIMARY KEY, value TEXT)"
        )

    def get(self, key: str, default: str = "") -> str:
        row = self.db.query_one(f"SELECT value FROM {TABLE} WHERE key=?", (key,))
        return row[0] if row else default

    def set(self, key: str, value: str) -> None:
        self.db.execute(
            f"INSERT INTO {TABLE} (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            (key, value),
        )

    def set_many(self, items: Dict[str, str]) -> None:
        """All-or-nothing upsert. Credential pairs (endpoint+token) must
        never be torn by a crash between two writes — a half-written pair
        would be trusted over fresh boot flags on the next start."""
        self.db.executemany(
            f"INSERT INTO {TABLE} (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            list(items.items()),
        )

    def set_credential_pair(self, endpoint: str, token: str) -> None:
        self.set_many(
            {KEY_ENDPOINT: normalize_endpoint(endpoint), KEY_TOKEN: token}
        )

    def delete(self, key: str) -> None:
        self.db.execute(f"DELETE FROM {TABLE} WHERE key=?", (key,))

    def all(self) -> Dict[str, str]:
        return {r[0]: r[1] for r in self.db.query(f"SELECT key, value FROM {TABLE}")}

    def machine_id(self) -> Optional[str]:
        v = self.get(KEY_MACHINE_ID)
        return v or None
