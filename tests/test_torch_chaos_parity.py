"""The port's 13 shipped chaos campaigns against the reference's, and the
first five short campaigns run on both packages (tests/torch_chaos_parity.py).

Each of gpud_tpu_torch/chaos/scenarios/ loads, validates and expands
(``expand_steps``, its crc32 jitter included) to the reference's timeline
with the nouns mapped: GPU components, the Xid analogs of
tests/test_torch_xid_catalog.py (``gpu_nvlink_error`` for the ICI link
loss, ``gpu_gsp_xid119`` for the fatal runtime error, which the port's
catalog lacks), ``gpu_id``, and GPU 0's NVLink ports for the ICI link and
port of ici-link-degrade. Then each campaign runs on a reference daemon and
a port daemon, each with its own fake plane, and gives the same verdicts
expectation by expectation and the same steps per action; the campaign's
``chaos_result`` outbox record is the reference's."""

import re

import pytest

from gpud_tpu.chaos import scenario as ref_scenario
from gpud_tpu_torch.chaos import scenario as port_scenario

from torch_chaos_parity import SHORT, check_campaign, daemons, journaled
from torch_parity import COMPONENTS

CATALOG = {"tpu_ici_link_down": "gpu_nvlink_error", "tpu_runtime_fatal": "gpu_gsp_xid119"}
LINKS = {"c0-c1/x": "gpu0/nvlink0", "chip5/ici1": "gpu0/nvlink1", "c5-c6/x": "gpu0/nvlink1"}
KEYS = {"chip_id": "gpu_id"}
NAMES = sorted(ref_scenario.shipped_scenarios())


def to_port(x):
    """A reference scenario's step or expectation in the port's nouns."""
    if isinstance(x, dict):
        return {KEYS.get(k, k): to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, str):
        return COMPONENTS.get(x) or CATALOG.get(x) or LINKS.get(x) or x
    return x


def timeline(mod, sc):
    return [(p.name, p.settle_seconds, [(o.offset, o.action, o.step_index, o.occurrence)
                                        for o in mod.expand_steps(
                                            p.steps, key_prefix=f"{sc.name}:{p.name}")])
            for p in sc.phases]


def test_the_port_ships_the_reference_s_campaigns():
    assert sorted(port_scenario.shipped_scenarios()) == NAMES and len(NAMES) == 13
    assert all(re.search(r"/gpud_tpu_torch/chaos/scenarios/[a-z-]+\.yaml$", p)
               for p in port_scenario.shipped_scenarios().values())


@pytest.mark.parametrize("name", NAMES)
def test_the_campaign_expands_to_the_reference_s_timeline(name):
    ref = ref_scenario.load_scenario(name)
    port = port_scenario.load_scenario(name)
    assert port.validate() is None
    assert (port.name, port.detect_timeout) == (ref.name, ref.detect_timeout)
    assert timeline(port_scenario, port) == timeline(ref_scenario, ref)
    assert port.duration_estimate() == ref.duration_estimate()
    for p, r in zip(port.phases, ref.phases):
        assert p.steps == to_port(r.steps)
        assert p.expect == to_port(r.expect)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    yield from daemons(tmp_path_factory)


@pytest.mark.parametrize("name", SHORT[:5])
def test_the_campaign_gives_the_reference_s_verdicts(pair, name):
    check_campaign(pair, name)


PRODUCER = {"name": "chaos-result-producer",
            "phases": [{"name": "p", "steps": [{"action": "fabric_sweep"}]}]}


def test_one_campaign_journals_one_chaos_result_as_the_reference(pair):
    rows = {}
    for pkg in ("ref", "port"):
        srv, cp = pair[pkg]
        before = journaled(srv, "chaos_result")
        res, err = srv.chaos.run_campaign(PRODUCER, wait=True)
        assert err is None and res["passed"]
        new = journaled(srv, "chaos_result")[len(before):]
        assert new == [(f"chaos:{PRODUCER['name']}:{res['id']}",
                        {"id": res["id"], "scenario": PRODUCER["name"], "passed": True,
                         "error": ""})]
        rows[pkg] = new
    assert rows["port"] == rows["ref"]
