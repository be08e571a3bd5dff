"""The reference's chaos tests (tests/test_chaos.py) on the port's chaos
harness (gpud_tpu_torch/chaos/).

Every case of the reference file runs on the port's modules through
tests/torch_ref_tests.py ``port_tests``, with tests/torch_live.py's noun
pairs and ``port_host`` (the mock GPUs, 127.0.0.1, the outside probes
stubbed): the scenario model and its timeline expansion, the fake-clock
runner and expectations, the injector's bursts, the remediation scan's
tolerance of a vanished component, and the hermetic two-fault campaign,
the HTTP surface, the session methods and the injectFault rate limit
against a live port daemon. The catalog names are the analogs of
tests/test_torch_xid_catalog.py: Xid 74 (``gpu_nvlink_error``) for the
ICI link loss, the GPU thermal trip for the TPU's. No case is excluded.
Then a case of the port's own: its fake plane's ingest lock makes the
manager rebuild atomic with ingest, as the reference's event loop does."""

from torch_live import REF_TO_PORT, port_host  # noqa: F401
from torch_ref_tests import port_tests

CHAOS_NOUNS = [
    ("tpu_ici_link_down", "gpu_nvlink_error"),
    ("tpu_thermal_trip", "gpu_thermal_trip"),
    ('"chip=3"', '"gpu=3"'),
    ('"chip=7"', '"gpu=7"'),
    ('count("chip=3")', 'count("gpu=3")'),
]

globals().update(port_tests("test_chaos.py", replace=REF_TO_PORT + CHAOS_NOUNS))


# -- the port's own: the fake plane's ingest lock --------------------------------------


def test_a_manager_rebuild_is_atomic_with_ingest(monkeypatch):
    """The reference's rebuild runs on its plane's event loop, so no
    delivery lands in the dying store; the port's holds the plane's
    ``ingest_lock``: a delivery that arrives mid-rebuild waits, then lands
    in the rebuilt store."""
    import threading
    import time

    from gpud_tpu_torch.chaos import faults
    from gpud_tpu_torch.chaos.fake_plane import FakeControlPlane
    from gpud_tpu_torch.chaos.runner import _Context
    from gpud_tpu_torch.manager import rollup as rollup_mod

    cp = FakeControlPlane()
    old = cp.attach_rollup()
    cp.start()
    try:
        rebuilding, release, out = threading.Event(), threading.Event(), []
        init = rollup_mod.FleetRollupStore.__init__

        def paused_init(self, *a, **kw):
            rebuilding.set()
            assert release.wait(10)
            init(self, *a, **kw)

        monkeypatch.setattr(rollup_mod.FleetRollupStore, "__init__", paused_init)
        ctx = _Context(time.time, time.sleep, cp, 1.0)
        kill = threading.Thread(target=lambda: out.append(
            faults.act_manager_kill_rebuild(None, {"shards": 3}, ctx)))
        kill.start()
        assert rebuilding.wait(10)
        delivered = threading.Event()
        deliver = threading.Thread(target=lambda: (cp._ingest_outbox("m1", {
            "outbox_seq": 1, "ts": 1.0, "kind": "event", "dedupe_key": "k1",
            "payload": {"component": "cpu", "name": "x"}}), delivered.set()))
        deliver.start()
        assert not delivered.wait(0.3)  # the delivery waits out the rebuild
        release.set()
        kill.join(10)
        deliver.join(10)
        assert out == [None] and delivered.is_set()
        assert cp.rollup is not old and cp.rollup.shard_count == 3
        assert old.records_total() == 0
        assert cp.rollup.journal_count() == cp.rollup.records_total() == 1
    finally:
        cp.stop()
