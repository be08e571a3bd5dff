"""The manager's peer federation; of ``gpud_tpu/manager/federation.py``
the port holds only the machine-id prefix of a peer's replication stream
so far.

``ControlPlane._register`` reads ``PEER_MACHINE_PREFIX`` on every
enrollment: on a federated manager a session whose machine id carries it
is a peer shipping its journal, and its records go to the replica store
instead of this manager's own pane. The rest of the module (the
``FederationPlane``, its shipper, fan-out and adoption) and
``manager/peers.py`` are ROADMAP item A12; until then ``ControlPlane``
has no ``attach_peers`` and its ``federation`` stays None, as on the
reference's standalone manager.
"""

from __future__ import annotations

# machine_id prefix a replication stream enrolls under on its successor
PEER_MACHINE_PREFIX = "peer:"
