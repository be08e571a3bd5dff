"""Both packages' planes side by side, for the parity tests of the predict
engine, the fabric sweep, the session wire codec and the outbox
(``tests/test_torch_{predict,predict_calibrate,fabric,session_wire,
session_outbox}.py``).

``REF`` and ``PORT`` hold the same module names, so one scenario function
runs on either and the tests compare what the two give. The scenarios are
the reference's own tests of each plane, run on both packages: each keeps
the reference test's assertions and returns what it observed, and the test
holds the port's observations equal to the reference's.
"""

from __future__ import annotations

import types

import gpud_tpu.fabric as ref_fabric
import gpud_tpu.fabric.mesh as ref_mesh
import gpud_tpu.fabric.plane as ref_plane
import gpud_tpu.fabric.store as ref_fabric_store
import gpud_tpu.predict as ref_predict
import gpud_tpu.predict.calibrate as ref_calibrate
import gpud_tpu.predict.engine as ref_engine
import gpud_tpu.predict.features as ref_features
import gpud_tpu.remediation.audit as ref_audit
import gpud_tpu.remediation.policy as ref_policy
import gpud_tpu.scheduler as ref_scheduler
import gpud_tpu.session.outbox as ref_outbox
import gpud_tpu.session.session as ref_session
import gpud_tpu.session.wire as ref_wire
import gpud_tpu.sqlite as ref_sqlite
import gpud_tpu.storage as ref_storage
from gpud_tpu.api.v1 import types as ref_types

import gpud_tpu_torch.fabric as port_fabric
import gpud_tpu_torch.fabric.mesh as port_mesh
import gpud_tpu_torch.fabric.plane as port_plane
import gpud_tpu_torch.fabric.store as port_fabric_store
import gpud_tpu_torch.predict as port_predict
import gpud_tpu_torch.predict.calibrate as port_calibrate
import gpud_tpu_torch.predict.engine as port_engine
import gpud_tpu_torch.predict.features as port_features
import gpud_tpu_torch.remediation.audit as port_audit
import gpud_tpu_torch.remediation.policy as port_policy
import gpud_tpu_torch.scheduler as port_scheduler
import gpud_tpu_torch.session.outbox as port_outbox
import gpud_tpu_torch.session.session as port_session
import gpud_tpu_torch.session.wire as port_wire
import gpud_tpu_torch.sqlite as port_sqlite
import gpud_tpu_torch.storage as port_storage
from gpud_tpu_torch.api.v1 import types as port_types

REF = types.SimpleNamespace(
    name="ref", fabric=ref_fabric, mesh=ref_mesh, plane=ref_plane,
    fabric_store=ref_fabric_store, predict=ref_predict, calibrate=ref_calibrate,
    engine=ref_engine, features=ref_features, audit=ref_audit, policy=ref_policy,
    scheduler=ref_scheduler, outbox=ref_outbox, session=ref_session, wire=ref_wire,
    sqlite=ref_sqlite, storage=ref_storage, types=ref_types,
)
PORT = types.SimpleNamespace(
    name="port", fabric=port_fabric, mesh=port_mesh, plane=port_plane,
    fabric_store=port_fabric_store, predict=port_predict, calibrate=port_calibrate,
    engine=port_engine, features=port_features, audit=port_audit, policy=port_policy,
    scheduler=port_scheduler, outbox=port_outbox, session=port_session, wire=port_wire,
    sqlite=port_sqlite, storage=port_storage, types=port_types,
)
PKGS = (REF, PORT)
IDS = ("ref", "port")


class Clock:
    """An injectable clock: ``clock()`` reads it, ``advance``/``set`` move it."""

    def __init__(self, now: float = 1000.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt

    def set(self, t: float) -> None:
        self.now = t


def both(scenario, *args, **kwargs):
    """``scenario`` run on the reference, then on the port: (ref, port)."""
    return scenario(REF, *args, **kwargs), scenario(PORT, *args, **kwargs)
