"""Both packages' daemon-core modules side by side, for the parity tests of
the config, scheduler, write-behind storage, health ledger, remediation and
native library (``tests/test_torch_{config,scheduler,storage_writer,
health_ledger,remediation,native,daemon_slice,state_cli}.py``).

``REF`` and ``PORT`` hold the same module names, so one scenario function
runs on either and the tests compare what the two give. ``schema`` and
``rows`` read a state DB the way the comparisons need it.
"""

from __future__ import annotations

import types

import gpud_tpu.config as ref_config
import gpud_tpu.eventstore as ref_eventstore
import gpud_tpu.health_history as ref_health_history
import gpud_tpu.metadata as ref_metadata
import gpud_tpu.metrics.registry as ref_registry
import gpud_tpu.metrics.store as ref_metrics_store
import gpud_tpu.remediation.actions as ref_actions
import gpud_tpu.remediation.audit as ref_audit
import gpud_tpu.remediation.engine as ref_engine
import gpud_tpu.remediation.policy as ref_policy
import gpud_tpu.scheduler.core as ref_scheduler
import gpud_tpu.sdnotify as ref_sdnotify
import gpud_tpu.sqlite as ref_sqlite
import gpud_tpu.storage.writer as ref_writer
from gpud_tpu.api.v1 import types as ref_types
from gpud_tpu.components import base as ref_base
from gpud_tpu.process import RunResult as RefRunResult

import gpud_tpu_torch.config as port_config
import gpud_tpu_torch.eventstore as port_eventstore
import gpud_tpu_torch.health_history as port_health_history
import gpud_tpu_torch.metadata as port_metadata
import gpud_tpu_torch.metrics.registry as port_registry
import gpud_tpu_torch.metrics.store as port_metrics_store
import gpud_tpu_torch.remediation.actions as port_actions
import gpud_tpu_torch.remediation.audit as port_audit
import gpud_tpu_torch.remediation.engine as port_engine
import gpud_tpu_torch.remediation.policy as port_policy
import gpud_tpu_torch.scheduler.core as port_scheduler
import gpud_tpu_torch.sdnotify as port_sdnotify
import gpud_tpu_torch.sqlite as port_sqlite
import gpud_tpu_torch.storage.writer as port_writer
from gpud_tpu_torch.api.v1 import types as port_types
from gpud_tpu_torch.components import base as port_base
from gpud_tpu_torch.process import RunResult as PortRunResult

REF = types.SimpleNamespace(
    name="ref", config=ref_config, eventstore=ref_eventstore,
    health_history=ref_health_history, metadata=ref_metadata, registry=ref_registry,
    metrics_store=ref_metrics_store, actions=ref_actions, audit=ref_audit,
    engine=ref_engine, policy=ref_policy, scheduler=ref_scheduler,
    sdnotify=ref_sdnotify, sqlite=ref_sqlite, writer=ref_writer,
    types=ref_types, base=ref_base, RunResult=RefRunResult,
)
PORT = types.SimpleNamespace(
    name="port", config=port_config, eventstore=port_eventstore,
    health_history=port_health_history, metadata=port_metadata, registry=port_registry,
    metrics_store=port_metrics_store, actions=port_actions, audit=port_audit,
    engine=port_engine, policy=port_policy, scheduler=port_scheduler,
    sdnotify=port_sdnotify, sqlite=port_sqlite, writer=port_writer,
    types=port_types, base=port_base, RunResult=PortRunResult,
)
PKGS = (REF, PORT)
IDS = ("ref", "port")

# the daemon's tables, created by its stores and by the planes it wires in
DAEMON_TABLES = (
    "tpud_health_transitions_v0_1",
    "tpud_health_last_state_v0_1",
    "tpud_remediation_audit_v0_1",
    "tpud_metrics_v0_1",
    "tpud_fabric_matrix_v0_1",
    "tpud_session_outbox_v0_1",
    "tpud_session_outbox_ack_v0_1",
)


def schema(db) -> dict:
    """name -> CREATE statement of every table and index in the DB."""
    return {name: sql for name, sql in db.query(
        "SELECT name, sql FROM sqlite_master WHERE sql IS NOT NULL ORDER BY name")}


def rows(db, table: str, order: str = "rowid") -> list:
    return [tuple(r) for r in db.query(f"SELECT * FROM {table} ORDER BY {order}")]


class Clock:
    """An injectable clock: ``clock()`` reads it, ``advance`` moves it."""

    def __init__(self, now: float = 1000.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt
