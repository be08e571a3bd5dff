"""Two of the four long chaos campaigns on the port alone
(tests/torch_chaos_parity.py ``check_on_port``): each passes every
expectation, runs its expanded timeline's steps per action and keeps
every latency within its bound. They wait out a partition or a failover
(tens of seconds each), so they run once, on the port;
tests/test_torch_chaos_long_more.py has the other two."""

import pytest

from torch_chaos_parity import LONG, check_on_port, daemons


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    yield from daemons(tmp_path_factory, pkgs=("port",))


@pytest.mark.parametrize("name", LONG[1:3])  # precursor-ramp, session-outbox-replay
def test_the_long_campaign_passes_on_the_port(port, name):
    check_on_port(port, name)
